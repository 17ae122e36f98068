/* fatt — the port's C ABI for embedding its flash attention in a host
 * framework: four attention entry points and an error pair, as the
 * reference's flash_attn.h has them.
 *
 * The port's own copy of flash_attn_tpu/runtime/native/fatpu_abi.h with the
 * port's fatt_ prefix.  fatt_attn_call is laid out field for field as
 * fatpu_attn_call, so one filled struct drives either library:
 *   - one params struct per call, versioned by struct_size;
 *   - a dtype enum (fp32, bf16, fp16 are served);
 *   - no *_rounded dims: the kernels mask ragged tiles themselves;
 *   - host buffers in and out and no stream handle: the registered
 *     executor moves the data to the card, runs the kernels and copies
 *     the results back before it returns.
 *
 * The math runs in the registered executor (the PyTorch runtime,
 * flash_attn_tpu_torch/runtime/abi.py:register_torch_executor); this file
 * is the stable boundary.
 */

#ifndef FATT_ABI_H_
#define FATT_ABI_H_

#include <stdbool.h>
#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef enum fatt_dtype {
  FATT_F32 = 0,
  FATT_BF16 = 1,
  FATT_F16 = 2,
  FATT_F8E4M3 = 3,
  FATT_I8 = 4,
} fatt_dtype;

/* Dense attention call: BSHD layouts; varlen packs tokens with cu_seqlens
 * prefix sums.  Host memory in and out. */
typedef struct fatt_attn_call {
  size_t struct_size; /* = sizeof(fatt_attn_call); ABI versioning */

  const void* q; /* [b, sq, h, d] dense, [total_q, h, d] varlen */
  const void* k; /* [b, sk, hk, d] / [total_k, hk, d] */
  const void* v;
  void* out;                /* same shape as q */
  float* lse;               /* optional: [b, h, sq] fp32 ([h, total_q] varlen) */
  const void* attn_mask;    /* optional additive fp32 bias */
  const int64_t* mask_dims; /* dims of attn_mask, broadcastable to [b, h, sq, sk]
                               (varlen: [total_q, total_k] or [h, total_q, total_k]) */
  int32_t mask_ndim;

  /* varlen only (null for dense): int32 prefix sums of length batch+1 */
  const int32_t* cu_seqlens_q;
  const int32_t* cu_seqlens_k;

  int32_t batch;
  int32_t seqlen_q; /* dense: sq; varlen: max_seqlen_q */
  int32_t seqlen_k;
  int32_t total_q; /* varlen only */
  int32_t total_k;
  int32_t num_heads;
  int32_t num_heads_k; /* GQA/MQA */
  int32_t head_dim;

  fatt_dtype dtype;
  float softmax_scale; /* 0 => 1/sqrt(head_dim) */
  float dropout_rate;
  uint64_t dropout_seed; /* counter-based, reproducible; taken as an int32 */
  bool is_causal;

  /* backward extension: non-null dout requests gradients */
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  const float* lse_in; /* residual from forward */
} fatt_attn_call;

/* Entry points. Return true on success; false => fatt_last_error(). */
bool fatt_attn_fwd(const fatt_attn_call* call);
bool fatt_attn_varlen_fwd(const fatt_attn_call* call);
bool fatt_attn_bwd(const fatt_attn_call* call);
bool fatt_attn_varlen_bwd(const fatt_attn_call* call);

/* Error subsystem: thread-local, so concurrent embedder threads do not
 * race on the message. */
void fatt_set_error(const char* msg);
const char* fatt_last_error(void);

/* Executor registration: the runtime installs one callback per entry
 * point. kind: 0=fwd, 1=varlen_fwd, 2=bwd, 3=varlen_bwd. Returns the
 * previously registered executor (may be null). */
typedef bool (*fatt_executor_fn)(const fatt_attn_call* call);
fatt_executor_fn fatt_register_executor(int kind, fatt_executor_fn fn);

/* Introspection */
const char* fatt_version(void);

#ifdef __cplusplus
} /* extern "C" */
#endif

#endif /* FATT_ABI_H_ */
