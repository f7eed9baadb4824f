// Pieces of the GroupNorm+SiLU forward (groupnorm_silu.cu, K1) and backward
// (groupnorm_silu_bwd.cu, K2): the shape check both use. Each kernel's
// launch plan is chosen in Python and checked by its own C entry point.
#pragma once

#include "common.cuh"

namespace bd {
namespace gn {

inline bool bad_shape(int batch, int hw, int c, int groups) {
  return batch <= 0 || hw <= 0 || c <= 0 || groups <= 0 || c % groups != 0 ||
         (int64_t)batch * groups > 0x7fffffff || (int64_t)hw * c > 0x7fffffff;
}

}  // namespace gn
}  // namespace bd
