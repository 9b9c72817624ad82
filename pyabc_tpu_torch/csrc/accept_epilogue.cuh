// The epilogue of a uniform accept kernel, shared by K5 (pnorm_accept.cu)
// and K25 (aggregate.cu): from a lane's distance d, its accept flag and
// importance log weight.
//
//   accept = valid & (d <= eps) [& (d <= hist_min)]
//   log w = log_offset + logpri - logq   (transition rounds of one model),
//           0 for prior rounds (logpri null), -inf where the lane is
//           invalid;
//   K > 1 (m, model_logits and log_model_factor given, util.py:399-406):
//   log w = model_logits[m] + logpri - log_model_factor[m] - logq.
// eps and hist_min are device scalars (pointers).
#pragma once

#include <cstdint>

namespace pyabc {

struct AcceptTerms {
  const uint8_t* valid;
  const float* eps;
  const float* hist_min;  // nullable
  const float* logpri;    // nullable (prior rounds)
  const float* logq;
  float log_offset;
  const int* m;  // nullable (one model)
  const float* model_logits;
  const float* log_model_factor;
  float* d_out;
  uint8_t* acc_out;
  float* logw_out;
};

__device__ __forceinline__ void accept_epilogue(const AcceptTerms& t,
                                                int row_i, float d) {
  const bool v = t.valid[row_i] != 0;
  bool a = v && (d <= t.eps[0]);
  if (t.hist_min != nullptr) a = a && (d <= t.hist_min[0]);
  float lw = 0.f;
  if (!v)
    lw = -INFINITY;
  else if (t.logpri != nullptr && t.m != nullptr) {
    const int mi = t.m[row_i];
    lw = t.model_logits[mi] + t.logpri[row_i] - t.log_model_factor[mi] -
         t.logq[row_i];
  } else if (t.logpri != nullptr)
    lw = t.log_offset + t.logpri[row_i] - t.logq[row_i];
  t.d_out[row_i] = d;
  t.acc_out[row_i] = a ? 1 : 0;
  t.logw_out[row_i] = lw;
}

}  // namespace pyabc
