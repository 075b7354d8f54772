"""Plain PyTorch references of the benchmark's models, in float64; they
import nothing of the program."""
