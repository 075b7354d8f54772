// bfloat16 as the kernels use it (see cuda_runtime.h beside this file)
#pragma once
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
  uint16_t bits;
};
inline float __bfloat162float(__nv_bfloat16 b) {
  const uint32_t u = (uint32_t)b.bits << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
