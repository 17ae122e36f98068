// fatt C ABI: error subsystem, executor dispatch, argument validation.
//
// The port's own copy of flash_attn_tpu/runtime/native/fatpu_abi.cc (the
// same validation messages and semantics, the fatt_ prefix).  Built with
// the host C++ compiler into one library with the page allocator
// (flash_attn_tpu_torch/runtime/abi.py); it needs no CUDA.

#include "fatt_abi.h"

#include <array>
#include <atomic>
#include <string>

namespace {

thread_local std::string g_last_error;

// One executor slot per entry-point kind; atomics so registration from the
// host runtime thread is safe against concurrent callers.
std::array<std::atomic<fatt_executor_fn>, 4> g_executors{};

bool fail(const char* msg) {
  fatt_set_error(msg);
  return false;
}

bool validate(const fatt_attn_call* call, bool varlen, bool backward) {
  if (call == nullptr) return fail("null call struct");
  if (call->struct_size < sizeof(fatt_attn_call))
    return fail("struct_size too small: header/library version mismatch");
  if (!call->q || !call->k || !call->v) return fail("null q/k/v pointer");
  if (!backward && !call->out) return fail("null out pointer");
  if (call->batch <= 0 || call->num_heads <= 0 || call->head_dim <= 0)
    return fail("non-positive batch/num_heads/head_dim");
  if (call->num_heads_k <= 0 || call->num_heads % call->num_heads_k != 0)
    return fail("num_heads must be a positive multiple of num_heads_k");
  if (call->dropout_rate < 0.0f || call->dropout_rate >= 1.0f)
    return fail("dropout_rate must be in [0, 1)");
  if (varlen) {
    if (!call->cu_seqlens_q || !call->cu_seqlens_k)
      return fail("varlen call requires cu_seqlens_q/k");
    if (call->total_q <= 0 || call->total_k <= 0)
      return fail("varlen call requires positive total_q/total_k");
  } else {
    if (call->seqlen_q <= 0 || call->seqlen_k <= 0)
      return fail("non-positive seqlen_q/seqlen_k");
  }
  if (backward) {
    if (!call->dout || !call->dq || !call->dk || !call->dv)
      return fail("backward call requires dout and dq/dk/dv");
    if (!call->lse_in) return fail("backward call requires lse_in residual");
  }
  return true;
}

bool dispatch(int kind, const fatt_attn_call* call) {
  fatt_executor_fn fn = g_executors[kind].load(std::memory_order_acquire);
  if (fn == nullptr)
    return fail(
        "no executor registered: the host runtime must call "
        "fatt_register_executor() before issuing attention calls");
  return fn(call);
}

}  // namespace

extern "C" {

void fatt_set_error(const char* msg) { g_last_error = msg ? msg : ""; }

const char* fatt_last_error(void) { return g_last_error.c_str(); }

fatt_executor_fn fatt_register_executor(int kind, fatt_executor_fn fn) {
  if (kind < 0 || kind >= 4) return nullptr;
  return g_executors[kind].exchange(fn, std::memory_order_acq_rel);
}

bool fatt_attn_fwd(const fatt_attn_call* call) {
  if (!validate(call, /*varlen=*/false, /*backward=*/false)) return false;
  return dispatch(0, call);
}

bool fatt_attn_varlen_fwd(const fatt_attn_call* call) {
  if (!validate(call, /*varlen=*/true, /*backward=*/false)) return false;
  return dispatch(1, call);
}

bool fatt_attn_bwd(const fatt_attn_call* call) {
  if (!validate(call, /*varlen=*/false, /*backward=*/true)) return false;
  return dispatch(2, call);
}

bool fatt_attn_varlen_bwd(const fatt_attn_call* call) {
  if (!validate(call, /*varlen=*/true, /*backward=*/true)) return false;
  return dispatch(3, call);
}

const char* fatt_version(void) { return "fatt-0.1.0"; }

}  // extern "C"
