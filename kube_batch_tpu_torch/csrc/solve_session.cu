// The whole-session allocate solve as one CUDA kernel, for sm_90a (H100).
//
// Replaces the TPU kernel kube_batch_tpu/ops/pallas_solver.py:60
// `_solve_kernel` (launched by `solve_allocate_pallas`, pallas_call at
// :470).  One launch runs one allocate session: queue pop, job pop, a
// drain of the popped job's tasks (one placement per task), and the
// write-back of the job's and queue's fairness state, until no queue is
// active.  The wrapper is kube_batch_tpu_torch/ops/cuda_solver.py; its
// plain PyTorch version `solve_allocate_plain` is the same algorithm one
// torch op at a time, and must agree with this kernel exactly.
//
// What bounds it on this card: not bytes and not arithmetic, but the
// serial chain of placements.  A session of ~50k placements is ~50k
// dependent steps, each one scan over N nodes plus a reduction to pick the
// node, and the next step reads the node state the previous one wrote.
//
// What this design does about it: one launch is ONE thread-block cluster
// of C CTAs (C in 1, 2, 4, 8; `cluster_plan` in the wrapper picks it), so
// no step pays a launch or a host round trip, and the node state lives on
// chip, as the TPU kernel keeps it in VMEM.  CTA k owns the contiguous
// node slice [k*S, (k+1)*S); the slice's live rows (idle, releasing, used,
// count, cap, the two grid-score capacities, the current signature's
// feasibility bit and bonus, and the port and selector rows the conf
// uses) sit in its shared memory, row after row.  Rows that do not fit
// even at C = 8 stay in a global scratch mirror; generic pointers serve
// both, so every shape solves through the same code.  Node li of a slice
// belongs to thread li % kThreads of its CTA, which alone reads and
// writes that node's rows: the owner applies the rank-1 update, and the
// next scan needs no barrier for it.  Per placement each warp reduces its
// nodes to one packed int64 key (max score, then first index) and sends
// it into every CTA's exchange slots with st.async, which counts its
// bytes on that CTA's mbarrier; when its own CTA's mbarrier has all C x
// kWarps keys, every thread takes their max locally.  No fence and no
// cluster-wide barrier: a cluster barrier's release costs a GPU-scope
// fence per placement.  Slots and mbarriers alternate by placement
// parity; no CTA can refill a slot before every warp has read it, since
// it must first receive every warp's next key.  Pops need no traffic between CTAs: every CTA holds
// an identical copy of the job and queue state and runs the same pops and
// write-backs on it.  Warp 0 pops (the queue first, then the job from each
// warp's cached first job of that queue) and publishes the result behind
// one CTA barrier; the popped job's warp refreshes its cache entry at the
// write-back.  At the end each CTA writes back its node slice and CTA 0
// the job and queue state.
//
// Exactness, each point from the reference:
//  (a) ties break to the first index: max score, then the minimum node
//      index, across CTAs too; lexicographic pops take the minimum index
//      among equal keys;
//  (b) every integer sum is int32 and wraps (w* helpers below);
//  (c) the grid-score division is in the float key type and the share
//      division in float32, both IEEE-rounded: build WITHOUT
//      --use_fast_math;
//  (d) an empty pop mask gives index `dim`, which retires the queue;
//  (e) the kernel writes only the buffers the wrapper has just built;
//  (f) the conf's key orders, flags and weights are launch arguments.

#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

// Field order must match SolveArgs in ops/cuda_solver.py (tests compare).
struct SolveArgs {
  // device pointers
  int32_t* node_int;
  const int32_t* node_cs;
  const int32_t* task_data;
  const int32_t* task_sig;
  const void* sig_mask;
  const int32_t* sig_bonus;
  const void* jsta;
  int32_t* jdyn;
  const void* qsta;
  const int32_t* qdes;
  int32_t* qdyn;
  int32_t* nport;
  int32_t* nsel;
  const void* total;
  const int32_t* score_shift;
  int32_t* out;
  int32_t* steps;
  long long* stamps;  // phase cycles and counts (kPhaseSlots); null: off
  int32_t* scratch;   // what does not fit on chip (ClusterPlan.scratch_ints)
  // shapes
  int32_t n, p, jdim, qdim, r, np_pad, ns_pad, n_sig;
  // the cluster plan (ops/cuda_solver.py ClusterPlan)
  int32_t cluster, slice, rows, smem_rows, jsta_smem, jwork_smem, smem_bytes;
  // the conf
  int32_t w_least5, w_most5, w_bal;
  int32_t has_gang, has_proportion, has_ports, has_pod_affinity;
  int32_t has_pod_affinity_score;
  int32_t job_key0, job_key1, job_key2, queue_key0;
  // layout: row and column offsets (ops/cuda_solver.py Layout)
  int32_t idle, rel, used, cnt, cap, exists, ni_rows;
  int32_t req, res, ports, aff, anti, match, paffw, pantiw, task_width;
  int32_t jstart, jcount, jqueue, jmin, jprio, jts, juid, jsta_rows;
  int32_t jalloc, jptr, jready, jact, jdyn_rows;
  int32_t qts, quid, qexists, qdesf, qsta_rows;
  int32_t qdes_rows;
  int32_t qalloc, qact, qdyn_rows;
};

namespace {

constexpr int kThreads = 512;   // ops/cuda_solver.py THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 8;        // ops/cuda_solver.py MAX_R
constexpr int kMaxKeys = 5;     // up to 3 conf keys, then ts and uid rank
constexpr int kEps = 10;        // EPS_QUANTA
constexpr int kGridK = 1 << 12;  // SCORE_GRID_K
constexpr int kNegScore = -2147483647;  // SCORE_NEG_INF
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoCluster = -1;  // return code: no SM group can host the cluster
enum { kKeyNone = 0, kKeyPriority = 1, kKeyGang = 2, kKeyDrf = 3 };

// Phase stamps: clock64() cycles accumulated by thread 0 of CTA 0, per
// phase, then counts.  Slot order must match PHASES in ops/cuda_solver.py.
enum {
  kQueuePop, kJobPop, kNodeScan, kCtaReduce, kClusterExchange, kOwnerUpdate,
  kWriteBack, kPlacements, kPops, kTotal, kPhaseSlots
};

template <bool kOn>
struct Stamps {
  long long acc[kPhaseSlots];
  long long last, first;
  __device__ __forceinline__ void start() {
    if (!kOn) return;
#pragma unroll
    for (int i = 0; i < kPhaseSlots; ++i) acc[i] = 0;
    last = first = clock64();
  }
  // Charge the cycles since the previous mark to `phase`.
  __device__ __forceinline__ void mark(int phase) {
    if (!kOn) return;
    const long long now = clock64();
    acc[phase] += now - last;
    last = now;
  }
  __device__ __forceinline__ void count(int slot) {
    if (kOn) acc[slot] += 1;
  }
  __device__ __forceinline__ void write(long long* out, bool writer) {
    if (!kOn || !writer) return;
    acc[kTotal] = clock64() - first;
#pragma unroll
    for (int i = 0; i < kPhaseSlots; ++i) out[i] = acc[i];
  }
};

// int32 arithmetic that wraps, as XLA's does.
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
__device__ __forceinline__ int wabs(int a) {
  return a < 0 ? (int)(0u - (unsigned)a) : a;
}
// jax.lax.shift_right_logical: shifts of 32 or more give 0.
__device__ __forceinline__ int lshr(int a, int s) {
  return (unsigned)s >= 32u ? 0 : (int)((unsigned)a >> s);
}
// Epsilon LessEqual of one dim: l < m or |l - m| < eps.
__device__ __forceinline__ bool eps_le(int l, int m) {
  return (l < m) | (wabs(wsub(l, m)) < kEps);
}
// ops/fairness.py safe_share: float32 of float32 operands.
__device__ __forceinline__ float safe_share(float alloc, float total) {
  if (total == 0.0f) return alloc == 0.0f ? 0.0f : 1.0f;
  return alloc / total;
}

// One candidate of a lexicographic pop: keys, then the index; idx < 0 is
// "no candidate".
template <typename T>
struct Lex {
  T k[kMaxKeys];
  int idx;
};

template <typename T>
__device__ __forceinline__ bool lex_before(const Lex<T>& a, const Lex<T>& b) {
  // Key by key: a is before b at the first key where one is below the
  // other (keys neither below nor above count as equal), else by index.
  bool before = false, tied = true;
#pragma unroll
  for (int i = 0; i < kMaxKeys; ++i) {
    before = before | (tied & (a.k[i] < b.k[i]));
    tied = tied & !(a.k[i] < b.k[i]) & !(b.k[i] < a.k[i]);
  }
  before = before | (tied & (a.idx < b.idx));
  return a.idx >= 0 && (b.idx < 0 || before);
}

template <typename T>
__device__ __forceinline__ Lex<T> warp_lex_min(Lex<T> v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Lex<T> o;
#pragma unroll
    for (int i = 0; i < kMaxKeys; ++i) o.k[i] = __shfl_xor_sync(kFull, v.k[i], off);
    o.idx = __shfl_xor_sync(kFull, v.idx, off);
    if (lex_before(o, v)) v = o;
  }
  return v;
}

// A placement candidate as one int64: score in the high word, then the
// node index (reversed, so the larger key is the smaller index), then the
// node's fit-idle and fit-releasing bits.  The max key is (max score,
// first index).
__device__ __forceinline__ long long pack_key(int score, int idx, bool fit_idle,
                                              bool fit_rel) {
  unsigned long long hi = (unsigned long long)(unsigned)score << 32;
  unsigned long long lo = ((unsigned long long)(0x3fffffffu - (unsigned)idx) << 2) |
                          (fit_idle ? 2u : 0u) | (fit_rel ? 1u : 0u);
  return (long long)(hi | lo);
}

__device__ __forceinline__ long long warp_max(long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    long long o = __shfl_xor_sync(kFull, v, off);
    v = o > v ? o : v;
  }
  return v;
}

template <typename T>
__device__ __forceinline__ float drf_share(const SolveArgs& a, const int32_t* jdyn,
                                           const T* total, int j) {
  const int J = a.jdim;
  float share = 0.0f;
  for (int i = 0; i < a.r; ++i) {
    float s = safe_share((float)jdyn[(a.jalloc + i) * J + j], (float)total[i]);
    share = s > share ? s : share;
  }
  return share;
}

// jshare[j] is drf_share of job j, kept current by the job's owner thread.
// The exchange without a fence: st.async writes a key into another CTA's
// shared memory and counts its bytes on that CTA's mbarrier, whose phase
// completes when the bytes it expects have all landed (and its one local
// arrival came); a thread that sees the phase complete sees the bytes.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void store_async(uint32_t addr, long long v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];"
               ::"r"(addr), "l"(v), "r"(bar) : "memory");
}
__device__ __forceinline__ void arrive_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("{\n .reg .b64 st;\n"
               " mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}"
               ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void wait_parity(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

template <typename T>
__device__ __forceinline__ T job_key(const SolveArgs& a, const T* jsta,
                                     const int32_t* jw, const float* jshare, int code,
                                     int j) {
  const int J = a.jdim;
  if (code == kKeyPriority) return -jsta[a.jprio * J + j];
  if (code == kKeyGang)
    return (T)jw[a.jready * J + j] >= jsta[a.jmin * J + j] ? (T)1 : (T)0;
  if (code == kKeyDrf) return (T)jshare[j];
  return (T)0;
}

// Job j as a pop candidate: the conf's tiered keys, then ts, then uid rank.
template <typename T>
__device__ __forceinline__ Lex<T> job_lex(const SolveArgs& a, const T* jsta,
                                          const int32_t* jw, const float* jshare,
                                          const int* job_keys, int j) {
  const int J = a.jdim;
  Lex<T> c;
  c.idx = j;
#pragma unroll
  for (int s = 0; s < 3; ++s) c.k[s] = job_key(a, jsta, jw, jshare, job_keys[s], j);
  c.k[3] = jsta[a.jts * J + j];
  c.k[4] = jsta[a.juid * J + j];
  return c;
}

// The calling warp's first active job of queue q, over the jobs its lanes
// own (job j belongs to thread j % kThreads); idx -1 if none.  Every lane
// gets the answer.
template <typename T>
__device__ Lex<T> warp_best_job(const SolveArgs& a, const T* jsta, const int32_t* jw,
                                const float* jshare, const int* job_keys, int q) {
  const int J = a.jdim;
  const T qf = (T)q;
  Lex<T> best;
  best.idx = -1;
#pragma unroll 4
  for (int j = threadIdx.x; j < J; j += kThreads) {
    if (jw[a.jact * J + j] <= 0 || !(jsta[a.jqueue * J + j] == qf)) continue;
    const Lex<T> c = job_lex(a, jsta, jw, jshare, job_keys, j);
    if (lex_before(c, best)) best = c;
  }
  return warp_lex_min(best);
}

template <typename T>
__device__ __forceinline__ float queue_share(const SolveArgs& a, const T* qsta,
                                             const int32_t* qw, int q) {
  const int Q = a.qdim;
  float share = 0.0f;
  for (int i = 0; i < a.r; ++i) {
    float s = safe_share((float)qw[(a.qalloc + i) * Q + q],
                         (float)qsta[(a.qdesf + i) * Q + q]);
    share = s > share ? s : share;
  }
  return share;
}

// The node rows a CTA keeps for its slice, in the order the plan places
// them on chip (ops/cuda_solver.py node_rows).
struct RowIx {
  int idle, rel, used, cnt, cap, cs, sok, bonus, port, sel, np_use, ns_use;
};

__device__ __forceinline__ RowIx row_ix(const SolveArgs& a) {
  RowIx x;
  x.idle = 0;
  x.rel = a.r;
  x.used = 2 * a.r;
  x.cnt = 3 * a.r;
  x.cap = x.cnt + 1;
  x.cs = x.cnt + 2;     // two rows
  x.sok = x.cnt + 4;    // exists && sig_mask of the current signature
  x.bonus = x.cnt + 5;  // sig_bonus of the current signature
  x.port = x.cnt + 6;
  x.np_use = a.has_ports ? a.np_pad : 0;
  x.sel = x.port + x.np_use;
  x.ns_use = (a.has_pod_affinity || a.has_pod_affinity_score) ? a.ns_pad : 0;
  return x;
}

// Node row k of this CTA's slice: on chip for k < smem_rows, else in the
// global mirror.  Indexed by the node's place in the slice.  kOnChip: the
// plan put every row on chip, so no row needs the test.
template <bool kOnChip>
struct Rows {
  int32_t* sm;
  int32_t* gm;
  int stride_sm, stride_gm, in_smem;
  __device__ __forceinline__ int32_t* operator()(int k) const {
    if (kOnChip) return sm + k * stride_sm;
    return k < in_smem ? sm + k * stride_sm : gm + (size_t)k * stride_gm;
  }
};

// kR: the resource dims the task loops unroll (2 when r <= 2, else
// kMaxR); kOnChip: every node row is in shared memory.
template <typename T, bool kStamp, int kR, bool kOnChip>
__global__ void __launch_bounds__(kThreads, 1) solve_session(const SolveArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = a.cluster;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = a.n, J = a.jdim, Q = a.qdim, r = a.r;
  const int S = a.slice;
  const int base = rank * S;
  const int mine_n = max(0, min(S, n - base));
  const RowIx rx = row_ix(a);
  const int jw_rows = a.jact + 1, qw_rows = a.qact + 1;
  const T* sig_mask = static_cast<const T*>(a.sig_mask);
  const T* total = static_cast<const T*>(a.total);
  const int shift[2] = {a.score_shift[0], a.score_shift[1]};
  const int job_keys[3] = {a.job_key0, a.job_key1, a.job_key2};
  Stamps<kStamp> st;
  st.start();

  // ---- carve shared memory (ClusterPlan.smem_bytes mirrors this) -------
  long long* xslots = reinterpret_cast<long long*>(smem);  // [2][C*kWarps]
  // One mbarrier per parity: a phase completes when all C x kWarps keys of
  // that placement have landed and warp 0 has published the next task.
  unsigned long long* xbar = reinterpret_cast<unsigned long long*>(xslots + 2 * C * kWarps);
  int32_t* tbuf = reinterpret_cast<int32_t*>(xbar + 2);  // [2][32]
  int32_t* pop_sm = tbuf + 64;  // the pop's result, published by warp 0
  // The static job rows the pops read (start .. uid rank).
  const int js_rows = a.juid + 1;
  T* js_sm = reinterpret_cast<T*>(pop_sm + 8);
  const T* jsta = a.jsta_smem ? js_sm : static_cast<const T*>(a.jsta);
  // The queue piece, always on chip: the static queue rows the pops read
  // (ts, uid rank, exists, deserved floats), the dynamic copy, the job
  // cache (jcache[q * kWarps + w] is warp w's first active job of queue
  // q, -1 if none), qshare[q] (queue q's share, kept current) and the
  // deserved quanta.
  const int qs_rows = a.qdesf + r;
  T* qs_sm = a.jsta_smem ? js_sm + js_rows * J : js_sm;
  const T* qsta = qs_sm;
  int32_t* qw = reinterpret_cast<int32_t*>(qs_sm + qs_rows * Q);
  int32_t* jcache = qw + qw_rows * Q;
  float* qshare = reinterpret_cast<float*>(jcache + kWarps * Q);
  int32_t* qdes = reinterpret_cast<int32_t*>(qshare + Q);
  int32_t* cursor = qdes + r * Q;
  const int jpiece = (jw_rows + 1) * J;
  int32_t* gj = a.scratch + (size_t)a.rows * n;  // [C][jpiece]
  const Rows<kOnChip> row{cursor, a.scratch + base, S, n, a.smem_rows};
  cursor += a.smem_rows * S;
  // The job piece: the dynamic rows, then jshare.
  int32_t* jw = a.jwork_smem ? cursor : gj + (size_t)rank * jpiece;
  float* jshare = reinterpret_cast<float*>(jw + jw_rows * J);

  // ---- load the slice, the job and queue copies; clear `out` ----------
  for (int li = tid; li < mine_n; li += kThreads) {
    const int g = base + li;
    for (int d = 0; d < r; ++d) {
      row(rx.idle + d)[li] = a.node_int[(a.idle + d) * n + g];
      row(rx.rel + d)[li] = a.node_int[(a.rel + d) * n + g];
      row(rx.used + d)[li] = a.node_int[(a.used + d) * n + g];
    }
    row(rx.cnt)[li] = a.node_int[a.cnt * n + g];
    row(rx.cap)[li] = a.node_int[a.cap * n + g];
    row(rx.cs)[li] = a.node_cs[g];
    row(rx.cs + 1)[li] = a.node_cs[n + g];
    for (int k = 0; k < rx.np_use; ++k) row(rx.port + k)[li] = a.nport[k * n + g];
    for (int s = 0; s < rx.ns_use; ++s) row(rx.sel + s)[li] = a.nsel[s * n + g];
  }
  for (int i = tid; i < jw_rows * J; i += kThreads) jw[i] = a.jdyn[i];
  for (int j = tid; j < J; j += kThreads) jshare[j] = drf_share(a, a.jdyn, total, j);
  if (a.jsta_smem)
    for (int i = tid; i < js_rows * J; i += kThreads)
      js_sm[i] = static_cast<const T*>(a.jsta)[i];
  for (int i = tid; i < qw_rows * Q; i += kThreads) qw[i] = a.qdyn[i];
  for (int i = tid; i < qs_rows * Q; i += kThreads)
    qs_sm[i] = static_cast<const T*>(a.qsta)[i];
  for (int i = tid; i < r * Q; i += kThreads) qdes[i] = a.qdes[i];
  for (int t = rank * kThreads + tid; t < a.p; t += C * kThreads) {
    a.out[4 * t + 0] = -1;
    a.out[4 * t + 1] = 0;
    a.out[4 * t + 2] = -1;
    a.out[4 * t + 3] = 0;
  }
  if (tid == 0) {
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(xbar + i)));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // Every CTA of the cluster has started (its slots and mbarriers may be
  // used) and every copy above is visible.
  cluster.sync();
  uint32_t xphase = 0;  // bit p: the phase parity mbarrier p completes next
  for (int q = tid; q < Q; q += kThreads) qshare[q] = queue_share(a, qsta, qw, q);
  for (int q = 0; q < Q; ++q) {
    const int best = warp_best_job(a, jsta, jw, jshare, job_keys, q).idx;
    if (lane == 0) jcache[q * kWarps + warp] = best;
  }

  bool act = false;
  for (int q = tid; q < Q; q += kThreads) act |= qw[a.qact * Q + q] > 0;
  bool any_active = __syncthreads_or(act);
  int step = 0, par = 0, cur_sig = -1;

  while (any_active) {
    // ---- pops, in warp 0 alone: the other warps wait at the barrier,
    // which publishes the result (sixteen warps popping redundantly would
    // share the schedulers four to one) ----------------------------------
    if (warp == 0) {
      // queue pop: share, ts, uid rank
      Lex<T> qc;
      qc.idx = -1;
      for (int qq = lane; qq < Q; qq += 32) {
        if (qw[a.qact * Q + qq] <= 0) continue;
        Lex<T> c;
        c.idx = qq;
        c.k[0] = a.queue_key0 ? (T)qshare[qq] : (T)0;
        c.k[1] = qsta[a.qts * Q + qq];
        c.k[2] = qsta[a.quid * Q + qq];
        c.k[3] = (T)0;
        c.k[4] = (T)0;
        if (lex_before(c, qc)) qc = c;
      }
      qc = warp_lex_min(qc);
      const int pq = qc.idx < 0 ? Q : qc.idx;
      bool overused = false;
      if (a.has_proportion) {
        overused = true;
        for (int i = 0; i < r; ++i) {
          const int des = pq < Q ? qdes[i * Q + pq] : 0;
          const int alc = pq < Q ? qw[(a.qalloc + i) * Q + pq] : 0;
          bool ok = eps_le(des, alc);
          if (i >= 2) ok = ok || des <= kEps;
          overused = overused && ok;
        }
      }
      st.mark(kQueuePop);
      // job pop: the lex-first of the warps' cached candidates of queue
      // pq (only the popped job's keys change between two pops, and its
      // warp refreshes its entry at the write-back)
      Lex<T> jc;
      jc.idx = -1;
      if (pq < Q && lane < kWarps) {
        const int cj = jcache[pq * kWarps + lane];
        if (cj >= 0) jc = job_lex(a, jsta, jw, jshare, job_keys, cj);
      }
      jc = warp_lex_min(jc);
      if (lane == 0) {
        const int pj = jc.idx < 0 ? J : jc.idx;
        const bool found = pj < J;
        const bool gone = overused || !found;
        pop_sm[0] = pq;
        pop_sm[1] = pj;
        pop_sm[2] = gone;
        pop_sm[3] = found ? (int)jsta[a.jstart * J + pj] : 0;
        pop_sm[4] = gone ? 0 : (int)jsta[a.jcount * J + pj];
        pop_sm[5] = found ? (int)jsta[a.jmin * J + pj] : 0;
        pop_sm[6] = found ? jw[a.jptr * J + pj] : 0;
        pop_sm[7] = found ? jw[a.jready * J + pj] : 0;
      }
    }
    __syncthreads();
    const int q = pop_sm[0], j = pop_sm[1];
    const bool retire = pop_sm[2] != 0;
    const int start = pop_sm[3], count_j = pop_sm[4], minavail = pop_sm[5];
    int ptr = pop_sm[6], ready_cnt = pop_sm[7];
    st.mark(kJobPop);
    st.count(kPops);

    // ---- drain the popped job: one placement per iteration -------------
    bool survive = false;
    int dstep = step;
    int dres[kR];
#pragma unroll
    for (int d = 0; d < kR; ++d) dres[d] = 0;
    // The task of the first placement comes from global memory; each
    // placement's warp 0 fetches the next task (the job's next, which the
    // drain reaches only if this placement succeeds) into tbuf while the
    // scan runs, and its arrival on the exchange mbarrier publishes it.
    int t = 0, sig = 0;
    int req[kR], res[kR];
    if (ptr < count_j) {
      t = wadd(start, ptr);
      t = t < 0 ? 0 : (t > a.p - 1 ? a.p - 1 : t);
      const int32_t* task = a.task_data + (size_t)t * a.task_width;
#pragma unroll
      for (int d = 0; d < kR; ++d) {
        req[d] = d < r ? task[a.req + d] : 0;
        res[d] = d < r ? task[a.res + d] : 0;
      }
      sig = a.task_sig[t];
    }
    for (;;) {
      // Past the job's last task (always so for a retired pop) the
      // iteration places nothing and ends the drain: skip its scan.
      if (ptr >= count_j) {
        survive = false;
        break;
      }
      int tn = wadd(wadd(start, ptr), 1);
      tn = tn < 0 ? 0 : (tn > a.p - 1 ? a.p - 1 : tn);
      int next = 0;
      if (warp == 0 && lane <= 2 * r) {
        const int col = lane < r ? a.req + lane : a.res + lane - r;
        next = lane < 2 * r ? a.task_data[(size_t)tn * a.task_width + col]
                            : a.task_sig[tn];
      }
      const int32_t* task = a.task_data + (size_t)t * a.task_width;
      sig = sig < 0 ? 0 : (sig > a.n_sig - 1 ? a.n_sig - 1 : sig);

      if (sig != cur_sig) {  // cache the signature's rows for my nodes
        const T* mask_row = sig_mask + (size_t)sig * n + base;
        const int32_t* bonus_row = a.sig_bonus + (size_t)sig * n + base;
        for (int li = tid; li < mine_n; li += kThreads) {
          row(rx.sok)[li] = a.node_int[a.exists * n + base + li] > 0 &&
                            mask_row[li] > (T)0.5;
          row(rx.bonus)[li] = bonus_row[li];
        }
        cur_sig = sig;
      }

      long long best = LLONG_MIN;
      for (int li = tid; li < mine_n; li += kThreads) {
        bool fit_idle = true, fit_rel = true;
#pragma unroll
        for (int d = 0; d < kR; ++d) {
          if (d < r) {
            const bool low = d >= 2 && req[d] <= kEps;
            fit_idle = fit_idle & (low | eps_le(req[d], row(rx.idle + d)[li]));
            fit_rel = fit_rel & (low | eps_le(req[d], row(rx.rel + d)[li]));
          }
        }
        bool feas = (row(rx.sok)[li] != 0) & (row(rx.cnt)[li] < row(rx.cap)[li]) &
                    (fit_idle | fit_rel);
        for (int k = 0; k < rx.np_use; ++k)
          if (task[a.ports + k] > 0) feas = feas & !(row(rx.port + k)[li] > 0);
        if (a.has_pod_affinity) {
          for (int s = 0; s < rx.ns_use; ++s) {
            const bool have = row(rx.sel + s)[li] > 0;
            if (task[a.aff + s] > 0) feas = feas & have;
            if (task[a.anti + s] > 0) feas = feas & !have;
          }
        }
        int g[2];
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          const int cs = row(rx.cs + d)[li];
          int xs = lshr(wadd(row(rx.used + d)[li], res[d]), shift[d]);
          xs = xs < cs ? xs : cs;
          const int quot = (int)((T)wmul(xs, kGridK) / (T)(cs > 1 ? cs : 1));
          g[d] = cs == 0 ? kGridK : quot;
        }
        int score = 0;
        if (a.w_least5)
          score = wadd(score, wmul(a.w_least5, wsub(wsub(2 * kGridK, g[0]), g[1])));
        if (a.w_most5) score = wadd(score, wmul(a.w_most5, wadd(g[0], g[1])));
        if (a.w_bal)
          score = wadd(score, wmul(a.w_bal, wsub(10 * kGridK,
                                                 wmul(10, wabs(wsub(g[0], g[1]))))));
        if (a.has_pod_affinity_score) {
          for (int s = 0; s < rx.ns_use; ++s) {
            const int wd = wsub(task[a.paffw + s], task[a.pantiw + s]);
            score = wadd(score, wmul(wmul(kGridK, wd), row(rx.sel + s)[li]));
          }
        }
        score = wadd(score, row(rx.bonus)[li]);
        score = feas ? score : kNegScore;
        const long long key = pack_key(score, base + li, fit_idle, fit_rel);
        best = key > best ? key : best;
      }
      st.mark(kNodeScan);
      st.count(kPlacements);

      // ---- pick: warp max, keys to every CTA, one mbarrier phase -------
      best = warp_max(best);
      long long* xs = xslots + par * C * kWarps;
      int32_t* tb = tbuf + 32 * par;
      const uint32_t bar = smem_u32(xbar + par);
      if (warp == 0) {
        if (lane <= 2 * r) tb[lane] = next;
        __syncwarp();
        if (lane == 0) arrive_expect(bar, C * kWarps * sizeof(long long));
      }
      if (lane < C)
        store_async(map_rank(smem_u32(xs + rank * kWarps + warp), lane), best,
                    map_rank(bar, lane));
      st.mark(kCtaReduce);
      wait_parity(bar, (xphase >> par) & 1u);
      xphase ^= 1u << par;
      par ^= 1;
      best = LLONG_MIN;
      for (int m = lane; m < C * kWarps; m += 32) best = xs[m] > best ? xs[m] : best;
      best = warp_max(best);
      st.mark(kClusterExchange);

      const int best_score = (int)(unsigned)((unsigned long long)best >> 32);
      const unsigned lo = (unsigned)((unsigned long long)best & 0xffffffffull);
      const int pick = (int)(0x3fffffffu - (lo >> 2));
      const bool feasible_any = best_score > kNegScore;
      const bool alloc_ok = feasible_any && (lo & 2u);
      const bool pipe_ok = feasible_any && !(lo & 2u) && (lo & 1u);
      const bool placed = alloc_ok || pipe_ok;

      const int li = pick - base;
      if (placed && li >= 0 && li < mine_n && li % kThreads == tid) {
        // The owner of the chosen node: rank-1 update of its column.
        for (int d = 0; d < r; ++d) {
          int32_t* idle = row(rx.idle + d) + li;
          int32_t* rel = row(rx.rel + d) + li;
          int32_t* used = row(rx.used + d) + li;
          if (alloc_ok) *idle = wsub(*idle, res[d]);
          if (pipe_ok) *rel = wsub(*rel, res[d]);
          *used = wadd(*used, res[d]);
        }
        row(rx.cnt)[li] = wadd(row(rx.cnt)[li], 1);
        a.out[4 * t + 0] = pick;
        a.out[4 * t + 1] = alloc_ok ? 1 : 2;
        a.out[4 * t + 2] = dstep;
        a.out[4 * t + 3] = 0;
        for (int k = 0; k < rx.np_use; ++k) row(rx.port + k)[li] |= task[a.ports + k];
        for (int s = 0; s < rx.ns_use; ++s)
          row(rx.sel + s)[li] = wadd(row(rx.sel + s)[li], task[a.match + s]);
      }
      st.mark(kOwnerUpdate);
      if (placed) {
        ptr += 1;
        dstep += 1;
#pragma unroll
        for (int d = 0; d < kR; ++d)
          if (d < r) dres[d] = wadd(dres[d], res[d]);
      }
      if (alloc_ok) ready_cnt += 1;
      const bool ready = a.has_gang ? ready_cnt >= minavail : true;
      const bool remaining = ptr < count_j;
      if (!feasible_any || ready || !remaining) {
        survive = feasible_any && ready && remaining;
        break;
      }
      // Placed, so the next task is the one warp 0 fetched.
      t = tn;
#pragma unroll
      for (int d = 0; d < kR; ++d) {
        req[d] = d < r ? tb[d] : 0;
        res[d] = d < r ? tb[r + d] : 0;
      }
      sig = tb[2 * r];
    }

    // ---- write-back and rotation, on every CTA's own copy ---------------
    step = dstep;
    // The pop barrier stands between the pops' reads and these writes.
    if (!retire) {
      if (tid == j % kThreads) {  // the job's owner thread
        for (int d = 0; d < r; ++d)
          jw[(a.jalloc + d) * J + j] = wadd(jw[(a.jalloc + d) * J + j], dres[d]);
        jw[a.jptr * J + j] = ptr;
        jw[a.jready * J + j] = ready_cnt;
        jw[a.jact * J + j] = survive ? 1 : 0;
        jshare[j] = drf_share(a, jw, total, j);
      }
      if (warp == (j % kThreads) / 32) {  // its warp refreshes queue q's entry
        const int best = warp_best_job(a, jsta, jw, jshare, job_keys, q).idx;
        if (lane == 0) jcache[q * kWarps + warp] = best;
      }
      if (tid == 0 && q < Q) {
        for (int d = 0; d < r; ++d)
          qw[(a.qalloc + d) * Q + q] = wadd(qw[(a.qalloc + d) * Q + q], dres[d]);
        qshare[q] = queue_share(a, qsta, qw, q);
      }
    } else if (tid == 0 && q < Q) {
      qw[a.qact * Q + q] = 0;
    }
    // Only the popped queue's active flag can have changed, and every
    // thread knows its new value, so one barrier serves.
    act = false;
    for (int qq = tid; qq < Q; qq += kThreads)
      act |= (qq == q && retire) ? false : qw[a.qact * Q + qq] > 0;
    any_active = __syncthreads_or(act);
    st.mark(kWriteBack);
  }

  // ---- write back: each CTA its node slice, CTA 0 the job/queue state --
  for (int li = tid; li < mine_n; li += kThreads) {
    const int g = base + li;
    for (int d = 0; d < r; ++d) {
      a.node_int[(a.idle + d) * n + g] = row(rx.idle + d)[li];
      a.node_int[(a.rel + d) * n + g] = row(rx.rel + d)[li];
      a.node_int[(a.used + d) * n + g] = row(rx.used + d)[li];
    }
    a.node_int[a.cnt * n + g] = row(rx.cnt)[li];
    for (int k = 0; k < rx.np_use; ++k) a.nport[k * n + g] = row(rx.port + k)[li];
    for (int s = 0; s < rx.ns_use; ++s) a.nsel[s * n + g] = row(rx.sel + s)[li];
  }
  if (rank == 0) {
    for (int i = tid; i < jw_rows * J; i += kThreads) a.jdyn[i] = jw[i];
    for (int i = tid; i < qw_rows * Q; i += kThreads) a.qdyn[i] = qw[i];
    if (tid == 0) *a.steps = step;
  }
  st.write(a.stamps, rank == 0 && tid == 0);
  // No CTA leaves while another may still address its shared memory.
  cluster.sync();
}

// The dynamic shared memory a launch carves (ClusterPlan.smem_bytes).
template <typename T>
size_t smem_bytes(const SolveArgs& a) {
  size_t b = 2 * (size_t)a.cluster * kWarps * sizeof(long long) + 2 * sizeof(long long) +
             72 * sizeof(int32_t);
  if (a.jsta_smem) b += (size_t)(a.juid + 1) * a.jdim * sizeof(T);
  b += (size_t)(a.qact + 2 + kWarps + a.r) * a.qdim * sizeof(int32_t) +
       (size_t)(a.qdesf + a.r) * a.qdim * sizeof(T);
  b += (size_t)a.smem_rows * a.slice * sizeof(int32_t);
  if (a.jwork_smem) b += (size_t)(a.jact + 2) * a.jdim * sizeof(int32_t);
  return b;
}

template <typename T, bool kStamp, int kR, bool kOnChip>
int launch(const SolveArgs& a, cudaStream_t s) {
  auto kernel = solve_session<T, kStamp, kR, kOnChip>;
  const int rows = 3 * a.r + 6 + (a.has_ports ? a.np_pad : 0) +
                   (a.has_pod_affinity || a.has_pod_affinity_score ? a.ns_pad : 0);
  if ((size_t)a.smem_bytes != smem_bytes<T>(a) || a.rows != rows || a.cluster < 1 ||
      a.cluster > 16 || (size_t)a.slice * a.cluster < (size_t)a.n || 2 * a.r + 1 > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (a.cluster > 8) {  // 16 CTAs: Hopper's non-portable cluster size
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = a.smem_bytes;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (clusters < 1) return kNoCluster;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kStamp>
int launch_for(const SolveArgs& a, cudaStream_t s) {
  const bool on_chip = a.smem_rows == a.rows;
  if (a.r <= 2)
    return on_chip ? launch<T, kStamp, 2, true>(a, s) : launch<T, kStamp, 2, false>(a, s);
  return on_chip ? launch<T, kStamp, kMaxR, true>(a, s)
                 : launch<T, kStamp, kMaxR, false>(a, s);
}

}  // namespace

extern "C" int kbt_solve_session(const SolveArgs* args, int use_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool stamp = args->stamps != nullptr;
  if (use_f64)
    return stamp ? launch_for<double, true>(*args, s) : launch_for<double, false>(*args, s);
  return stamp ? launch_for<float, true>(*args, s) : launch_for<float, false>(*args, s);
}

extern "C" const char* kbt_error_string(int code) {
  if (code == kNoCluster)
    return "no group of SMs can host the thread-block cluster "
           "(cudaOccupancyMaxActiveClusters returned 0)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
