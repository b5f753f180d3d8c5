// Backtrace of the general-N pairwise-overlap Viterbi over a batch of
// windows (kernel 4 of the decode path): a per-window pointer chase over
// the packed choices that ovn_forward_mb (kernel 3) or ovn_mc_forward_mb
// (kernel 11) wrote, on the chase machine of csrc/bt_chase.cuh with the
// general-N step decoder below.
//
// Replaces: hmmspikesorter_tpu/ops/pallas_viterbi_ovn_mb.py
// `_make_bt_kernel` (launched by `_backtrace_native`). The decision tree is
// that kernel's and ring_viterbi_ovn's `back`.
//
// Inputs: flags (B, W, 1+N+P) u8, rings (B, W, N, K-1) u8,
//         rowcol (B, W, 2P, K-1) u8, xT (B,) i32, the int32 topology table
//         of ops/viterbi_ovn_mb.py (pair members, pairs containing n,
//         third-member maps; (q << 1) | is_i per entry).
// Output: labels (B, W) i16 (S <= 32767 for every N, K the forward takes);
//         optionally (B, 2) i32 statistics: fix-up passes, re-chased steps.
//
// What bounds it on an H100: latency. The chase needs one choice byte a
// step (none inside a pair grid's diagonal) and writes a two-byte label,
// ~3.3 MB at N=3 over 128 windows of 8704, but step t-1 depends on the
// label at step t. A step holds 1+N+P + (N+2P)(K-1) bytes (538 at N=3,
// K=60), so staging every byte in shared memory (the first port) moves
// ~600 MB there; the segment design reads one 32-byte sector a step
// and spreads a window's W dependent steps over G lanes, so what is left
// is the global-load latency of W/G steps plus the fix-up passes'
// re-chases, about a spike's length each.

#include "bt_chase.cuh"

namespace {

// The general-N step decoder. Streams: 0 flags [silent | N onsets | P
// corners], 1 rings (N, K-1), 2 rowcol (2P, K-1) (rows q, columns P+q).
struct OvnPolicy : bt::Flat {
  struct Params {
    const uint8_t* flags;
    const uint8_t* rings;
    const uint8_t* rowcol;
    const int32_t* itab;
    int n_i, N, Km1;
  };
  int P, nO;
  const int* pi;      // (P,)
  const int* pj;      // (P,)
  const int* qn;      // (N, N-1)
  const int* rowt;    // (P, N-2)
  const int* colt;    // (P, N-2)

  static __host__ __device__ int stream_bytes(const Params& p, int k) {
    const int P = p.N * (p.N - 1) / 2;
    return k == 0 ? 1 + p.N + P : k == 1 ? p.N * p.Km1 : 2 * P * p.Km1;
  }
  static __host__ __device__ int table_ints_padded(const Params& p) {
    return (p.n_i + 3) & ~3;
  }
  __device__ void init(const Params& p, int* tabs) {
    Flat::init(p.N, p.Km1);
    for (int i = threadIdx.x; i < p.n_i; i += blockDim.x) tabs[i] = p.itab[i];
    P = N * (N - 1) / 2;
    nO = N - 2;
    pi = tabs;
    pj = tabs + P;
    qn = tabs + 2 * P;
    rowt = qn + N * (N - 1);
    colt = rowt + P * nO;
  }
  __device__ bt::Rows rows(const Params& p, size_t b, int W) const {
    bt::Rows r;
    for (int k = 0; k < 3; ++k) r.w[k] = stream_bytes(p, k);
    r.p[0] = p.flags + b * W * r.w[0];
    r.p[1] = p.rings + b * W * r.w[1];
    r.p[2] = p.rowcol + b * W * r.w[2];
    return r;
  }

  // the choice byte state s needs at step t, or none (a diagonal cell)
  __device__ __forceinline__ const uint8_t* where(const bt::State& s,
                                                  const bt::Rows& r,
                                                  int t) const {
    const uint8_t* f = r.p[0] + static_cast<size_t>(t) * r.w[0];
    if (s.kind == 0) return f;
    if (s.kind == 1)
      return s.a == 0 ? f + 1 + s.m
                      : r.p[1] + static_cast<size_t>(t) * r.w[1] +
                            s.m * Km1 + s.a;
    if (s.a == 0 && s.b == 0) return f + 1 + N + s.m;
    const uint8_t* rc = r.p[2] + static_cast<size_t>(t) * r.w[2];
    if (s.a == 0) return rc + s.m * Km1 + s.b;                // row
    if (s.b == 0) return rc + (P + s.m) * Km1 + s.a;          // column
    return nullptr;
  }
  // the source state of a flag over [silent | singles' ends | pairs' ends]
  __device__ __forceinline__ bt::State src(int f) const {
    if (f == 0) return bt::silent();
    if (f <= N) return bt::single(f - 1, Km1 - 1);
    return bt::pair(f - 1 - N, Km1 - 1, Km1 - 1);
  }
  // cell of pair e >> 1 whose staying member is at pos and whose other
  // member is at its ring end (the member's slot is e & 1: 1 = i, 0 = j)
  __device__ __forceinline__ bt::State handback(int e, int pos) const {
    return (e & 1) ? bt::pair(e >> 1, pos, Km1 - 1)
                   : bt::pair(e >> 1, Km1 - 1, pos);
  }
  // the state at t-1 given s at t and the byte `where` named (v)
  __device__ __forceinline__ bt::State next(const bt::State& s, int v) const {
    if (s.kind == 0) return src(v);
    if (s.kind == 1) {
      if (s.a == 0) return src(v);
      return v == 0 ? bt::single(s.m, s.a - 1)
                    : handback(qn[s.m * (N - 1) + v - 1], s.a - 1);
    }
    if (s.a == 0 && s.b == 0) return src(v);
    if (s.a == 0)
      return v == 0 ? bt::single(pj[s.m], s.b - 1)
                    : handback(rowt[s.m * nO + v - 1], s.b - 1);
    if (s.b == 0)
      return v == 0 ? bt::single(pi[s.m], s.a - 1)
                    : handback(colt[s.m * nO + v - 1], s.a - 1);
    return bt::pair(s.m, s.a - 1, s.b - 1);                   // diagonal
  }
};

OvnPolicy::Params params(const uint8_t* flags, const uint8_t* rings,
                         const uint8_t* rowcol, const int32_t* itab, int n_i,
                         int N, int Km1) {
  return {flags, rings, rowcol, itab, n_i, N, Km1};
}

}  // namespace

// segments: the lanes a window (ops/bt_segments.bt_launch_plan); stats:
// (B, 2) int32, zeroed by the caller, or null.
extern "C" int ovn_backtrace_mb(const uint8_t* flags, const uint8_t* rings,
                                const uint8_t* rowcol, const int32_t* xT,
                                int B, int W, int N, int Km1,
                                const int32_t* itab, int n_i,
                                int16_t* labels, int segments,
                                int32_t* stats, void* stream) {
  if (N < 2 || Km1 < 1) return static_cast<int>(cudaErrorInvalidValue);
  return bt::launch<OvnPolicy>(
      params(flags, rings, rowcol, itab, n_i, N, Km1), xT, B, W, segments,
      labels, stats, static_cast<cudaStream_t>(stream));
}

// out: {threads, shared bytes, tile steps, resident CTAs an SM, registers,
// spill bytes} of the design for windows of W steps.
extern "C" int ovn_backtrace_attrs(int W, int N, int Km1, int n_i,
                                   int segments, int* out) {
  return bt::attrs<OvnPolicy>(
      params(nullptr, nullptr, nullptr, nullptr, n_i, N, Km1), W, segments,
      out);
}
