"""The bound arithmetic reproduces the bounds the port's kernel table
records (H100 SXM peaks; bytes read and written once), and times a work
of exponentials alone."""

import pytest

from portbench import roofline


@pytest.mark.parametrize(
    ("op", "shape", "ms", "by"),
    [
        ("comoment_reduce", {"r": 10**8, "v": 1, "order": 6}, 0.239, "bytes"),
        ("comoment_reduce", {"r": 10**8, "v": 2, "order": 1}, 0.358, "bytes"),
        ("comoment_boot", {"r": 10**8, "v": 1, "order": 6, "nrep": 256}, 18.3, "draws"),
        ("comoment_boot", {"r": 10**7, "v": 1, "order": 6, "nrep": 256}, 1.83, "draws"),
        ("umoment_boot", {"b": 64, "n": 10**6, "order": 6, "nrep": 256}, 0.70, "products"),
        ("umoment_reduce", {"b": 64, "n": 10**6, "order": 6}, 0.076, "bytes"),
        (None, {"exps": 4.18e10}, 10.0, "exps"),  # a work given as it is: exponentials alone
    ],
)
def test_bounds(op, shape, ms, by):
    got, got_by = roofline.bound(roofline.op(op).work(**shape) if op else shape)
    assert got == pytest.approx(ms, rel=0.01)
    assert got_by == by


def test_share_is_a_percentage_of_the_time():
    assert roofline.share_pct("comoment_boot", 36.68, r=10**8, v=1, order=6, nrep=256) == pytest.approx(50.0, rel=1e-3)
