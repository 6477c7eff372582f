// CPU Adam/AdamW — host-side optimizer for ZeRO-Offload.
//
// Role parity with the reference csrc/adam/cpu_adam{,_impl}.cpp [K]:
// vectorized Adam over fp32 master shards resident in host RAM, so the
// device (TPU) only holds compute params; states never touch HBM.
//
// TPU-first adaptation: no torch/CUDA coupling — plain C ABI consumed via
// ctypes; OpenMP across chunks; auto-vectorizable inner loop (gcc emits
// AVX2/AVX-512 or NEON per -march). A bf16 emit path writes the updated
// params directly in the wire format the device expects, saving one host
// cast pass.

#include <cmath>
#include <cstdint>
#include <cstring>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// One fused Adam(W) step over a contiguous fp32 shard.
// adamw_mode: 1 → decoupled weight decay (AdamW), 0 → L2-into-grad Adam.
// bias_correction: 1 → standard Adam bias correction using `step` (1-based).
void ds_adam_step(float* params, const float* grads, float* exp_avg,
                  float* exp_avg_sq, int64_t n, int step, float lr,
                  float beta1, float beta2, float eps, float weight_decay,
                  int adamw_mode, int bias_correction) {
  const float bc1 = bias_correction ? 1.0f - std::pow(beta1, (float)step) : 1.0f;
  const float bc2 = bias_correction ? 1.0f - std::pow(beta2, (float)step) : 1.0f;
  const float step_size = lr / bc1;
  const float bc2_sqrt = std::sqrt(bc2);

#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    float g = grads[i];
    float p = params[i];
    if (!adamw_mode && weight_decay != 0.0f) g += weight_decay * p;
    float m = beta1 * exp_avg[i] + (1.0f - beta1) * g;
    float v = beta2 * exp_avg_sq[i] + (1.0f - beta2) * g * g;
    exp_avg[i] = m;
    exp_avg_sq[i] = v;
    float denom = std::sqrt(v) / bc2_sqrt + eps;
    // decoupled decay uses plain lr (NOT bias-corrected step_size)
    if (adamw_mode && weight_decay != 0.0f) p *= (1.0f - lr * weight_decay);
    params[i] = p - step_size * (m / denom);
  }
}

// Same step, but also emit the updated params as bf16 (round-to-nearest-even)
// into `out_bf16` — the copy the device consumes.
void ds_adam_step_bf16(float* params, const float* grads, float* exp_avg,
                       float* exp_avg_sq, uint16_t* out_bf16, int64_t n,
                       int step, float lr, float beta1, float beta2, float eps,
                       float weight_decay, int adamw_mode, int bias_correction) {
  ds_adam_step(params, grads, exp_avg, exp_avg_sq, n, step, lr, beta1, beta2,
               eps, weight_decay, adamw_mode, bias_correction);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    uint32_t bits;
    std::memcpy(&bits, &params[i], sizeof(bits));
    uint32_t rounding = 0x7FFF + ((bits >> 16) & 1);
    bits += rounding;
    out_bf16[i] = (uint16_t)(bits >> 16);
  }
}

// Adagrad (reference csrc/adagrad/cpu_adagrad.cpp [K]).
void ds_adagrad_step(float* params, const float* grads, float* exp_avg_sq,
                     int64_t n, int /*step*/, float lr, float eps,
                     float weight_decay) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    float g = grads[i];
    if (weight_decay != 0.0f) g += weight_decay * params[i];
    float v = exp_avg_sq[i] + g * g;
    exp_avg_sq[i] = v;
    params[i] -= lr * g / (std::sqrt(v) + eps);
  }
}

// Lion (reference csrc/lion/cpu_lion.cpp [K]).
void ds_lion_step(float* params, const float* grads, float* exp_avg,
                  int64_t n, int /*step*/, float lr, float beta1, float beta2,
                  float weight_decay) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    float g = grads[i];
    float p = params[i];
    float m = exp_avg[i];
    float c = beta1 * m + (1.0f - beta1) * g;
    float update = (c > 0.0f) - (c < 0.0f);  // sign
    if (weight_decay != 0.0f) p -= lr * weight_decay * p;
    params[i] = p - lr * update;
    exp_avg[i] = beta2 * m + (1.0f - beta2) * g;
  }
}

int ds_cpu_adam_num_threads() {
#if defined(_OPENMP)
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
