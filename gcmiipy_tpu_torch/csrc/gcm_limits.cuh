// The limits every kernel source of the port launches within: the most
// layers a column holds (ops/fused_parts.py's MAX_LAYERS) and the threads
// of a block.  Kept apart from gcm_stencil.cuh, which calls power, so that
// a source that includes only this needs no float64 library of its own
// (ops/cuda_lib.py:calls_power).

#pragma once

namespace gcm {

constexpr int kMaxLayers = 32;
constexpr int kBlock = 128;

inline bool bad_shape(int L, int H, int W) {
  return L < 1 || L > kMaxLayers || H < 1 || H > 65535 || W < 1;
}

}  // namespace gcm
