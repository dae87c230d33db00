// Host stand-ins for the bfloat16 names of mxu_anal.cuh (round to nearest
// even; the emulation runs no bfloat16 kernel).
#pragma once
#include <cstring>
struct __nv_bfloat16 { unsigned short v; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  u += 0x7fff + ((u >> 16) & 1);
  return {static_cast<unsigned short>(u >> 16)};
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 b) { return b.v; }
