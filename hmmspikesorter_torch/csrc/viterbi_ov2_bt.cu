// Backtrace of the N=2 pairwise-overlap Viterbi over a batch of windows
// (kernel 2 of the decode path): a per-window pointer chase over the packed
// choices that ov2_forward_mb (kernels 1 and 16) wrote, on the chase
// machine of csrc/bt_chase.cuh with the N=2 step decoder below.
//
// Replaces: hmmspikesorter_tpu/ops/pallas_viterbi_mb.py
// `_make_backtrace_kernel` (launched by `_backtrace_mb_pallas`). The
// decision tree mirrors that kernel's and ring_viterbi_ov2's `back`.
//
// Inputs: flags (B, W) u8, rings (B, W, K-1) u8, xT (B,) i32.
// Output: labels (B, W) i16 (S <= 32767 whenever K-1 <= 64); optionally
//         (B, 2) i32 statistics: fix-up passes, re-chased steps.
//
// What bounds it on an H100: latency, not bytes. The chase needs about two
// bytes a step in and writes two, but step t-1 depends on the label at
// step t. Staging a step's K bytes in shared memory (the first port) moves
// ~133 MB at 256 windows of 8672; the segment design reads one 32-byte
// sector a step (the flag stream's lines serve many silent steps) and
// spreads a window's W dependent steps over G lanes, so what is left
// is the load latency of W/G steps plus the fix-up passes' re-chases.

#include "bt_chase.cuh"

namespace {

// The N=2 step decoder. Streams: 0 flags (bp_sil | b0_on << 2 |
// b1_on << 3), 1 rings (K-1: bit 0 neuron 0's, bit 1 neuron 1's choice).
struct Ov2Policy : bt::Flat {
  struct Params {
    const uint8_t* flags;
    const uint8_t* rings;
    int Km1;
  };

  static __host__ __device__ int table_ints_padded(const Params&) {
    return 0;
  }
  __device__ void init(const Params& p, int*) { Flat::init(2, p.Km1); }
  __device__ bt::Rows rows(const Params& p, size_t b, int W) const {
    bt::Rows r;
    r.w[0] = 1;
    r.w[1] = p.Km1;
    r.w[2] = 0;
    r.p[0] = p.flags + b * W;
    r.p[1] = p.rings + b * W * p.Km1;
    r.p[2] = nullptr;
    return r;
  }

  // the choice byte state s needs at step t, or none (a pair cell)
  __device__ __forceinline__ const uint8_t* where(const bt::State& s,
                                                  const bt::Rows& r,
                                                  int t) const {
    if (s.kind == 0 || (s.kind == 1 && s.a == 0))
      return r.p[0] + static_cast<size_t>(t) * r.w[0];
    if (s.kind == 1)
      return r.p[1] + static_cast<size_t>(t) * r.w[1] + s.a;
    return nullptr;
  }
  // the state at t-1 given s at t and the byte `where` named (v)
  __device__ __forceinline__ bt::State next(const bt::State& s, int v) const {
    const int e = Km1 - 1;
    if (s.kind == 0) {
      const int bp = v & 3;
      return bp == 0 ? bt::silent()
           : bp == 1 ? bt::single(0, e)
           : bp == 2 ? bt::single(1, e)
                     : bt::pair(0, e, e);
    }
    if (s.kind == 1) {
      if (s.a == 0)                   // onset: the other neuron's ring end
        return ((v >> (2 + s.m)) & 1) ? bt::single(1 - s.m, e) : bt::silent();
      if (!((v >> s.m) & 1)) return bt::single(s.m, s.a - 1);
      return s.m == 0 ? bt::pair(0, s.a - 1, e) : bt::pair(0, e, s.a - 1);
    }
    if (s.a == 0 && s.b == 0) return bt::silent();
    if (s.b == 0) return bt::single(0, s.a - 1);
    if (s.a == 0) return bt::single(1, s.b - 1);
    return bt::pair(0, s.a - 1, s.b - 1);                     // diagonal
  }
};

}  // namespace

// segments: the lanes a window (ops/bt_segments.bt_launch_plan); stats:
// (B, 2) int32, zeroed by the caller, or null.
extern "C" int ov2_backtrace_mb(const uint8_t* flags, const uint8_t* rings,
                                const int32_t* xT, int B, int W, int Km1,
                                int16_t* labels, int segments,
                                int32_t* stats, void* stream) {
  if (Km1 < 1) return static_cast<int>(cudaErrorInvalidValue);
  return bt::launch<Ov2Policy>({flags, rings, Km1}, xT, B, W, segments,
                               labels, stats,
                               static_cast<cudaStream_t>(stream));
}

// out: {threads, shared bytes, tile steps, resident CTAs an SM, registers,
// spill bytes} of the design for windows of W steps.
extern "C" int ov2_backtrace_attrs(int W, int Km1, int segments, int* out) {
  return bt::attrs<Ov2Policy>({nullptr, nullptr, Km1}, W, segments, out);
}
