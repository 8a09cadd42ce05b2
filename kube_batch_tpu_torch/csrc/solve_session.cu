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
// of C CTAs (C in 1, 2, 4, 8, 16, at most what the card hosts; the
// wrapper's `cluster_plan` picks it), so no step pays a launch or a host
// round trip, and the node state lives on chip, as the TPU kernel keeps
// it in VMEM.  CTA k owns the contiguous node slice [k*S, (k+1)*S); the
// slice's live rows (idle, releasing, used, count, cap, the two
// grid-score capacities, the current signature's feasibility bit and
// bonus, and the port and selector rows the conf uses) sit in its shared
// memory, row after row.  What does not fit even at the largest cluster
// (the queue piece of many queues, node rows past a prefix, the job
// pieces) stays in a global scratch; generic pointers serve both, so
// every shape solves through the same code.  Any number of resource dims
// solves: up to kMaxR the task and the drain sums sit in registers,
// beyond it the kAnyR instantiation reads them from global memory.  Node
// li of a slice belongs to thread li % kThreads of its CTA, which alone
// reads and writes that node's rows: the owner applies the rank-1
// update, and the next scan needs no barrier for it.  Per placement each warp reduces its
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
//
// Shard mode (shards > 1; ops/cuda_solver.py solve_allocate_cuda_sharded,
// the mesh route of parallel/sharded_solver.py).  It replaces the
// reference's node-sharded solve (kube_batch_tpu/parallel/sharded_solver.py
// `solve_allocate_sharded`, an XLA while_loop with a pmax and a pmin per
// placement), not a Pallas kernel.  One launch per shard, each its own
// cluster, on its own stream: shard s holds the node slice [node_off,
// node_off + n) and the replicated task, job and queue state, so every
// shard runs the same pops.  Keys carry the GLOBAL node index.  After the
// cluster's exchange, CTA 0's thread 0 of each shard publishes the
// shard's key to its slot of the exchange buffer (host memory mapped into
// every device: slot (parity, shard) holds the key, then a tag, the
// solve's epoch and the exchange's sequence number, stored with a
// system-scope release), and warp 0 of CTA 0 alone acquires all K slots
// and takes their max: the max score, then the first global index, which
// is the reference's pmax of the score and pmin of (index << 2 | fit
// bits), since shards are contiguous.  CTA 0 then sends (max, ok) into
// every CTA's shared memory (st.async on a second pair of mbarriers), so
// the CTAs of a cluster go on or stop as one: a CTA that decided alone
// could stop while another waits for its key.  Every shard then records
// the placement; only the owner updates its node.  A slot cannot be
// refilled before CTA 0 has read it: a shard publishes exchange e + 2 only
// after its CTA 0 passed exchange e + 1, which needs every shard's key of
// e + 1, published after that shard's CTA 0 passed exchange e.
// The spin is bounded by %globaltimer (spin_ms; the SM clock that clock64
// counts varies with the power limit): past it, or once another shard
// raised the buffer's abort word, the shard raises the word, stops, and
// writes kind -1 for every task and steps -1, which the wrapper makes the
// solve's result (any shard's -1 poisons it) and the fetch turns into
// DeviceFailure.  What bounds it: the same serial chain, plus one round
// trip to host memory per placement.

#include <climits>
#include <cstdint>
#include <cstring>
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
  long long* xchg;    // shard mode: the exchange buffer (mapped host memory)
  // shapes
  int32_t n, p, jdim, qdim, r, np_pad, ns_pad, n_sig;
  // the cluster plan (ops/cuda_solver.py ClusterPlan)
  int32_t cluster, slice, rows, smem_rows, jsta_smem, jwork_smem, queue_smem;
  int32_t smem_bytes;
  // the conf
  int32_t w_least5, w_most5, w_bal;
  int32_t has_gang, has_proportion, has_ports, has_pod_affinity;
  int32_t has_pod_affinity_score;
  int32_t job_key0, job_key1, job_key2, queue_key0;
  // shard mode (shards 1: the single-device solve)
  int32_t shard, shards, node_off, epoch, spin_ms;
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
constexpr int kMaxR = 8;        // the most resource dims held in registers
constexpr int kAnyR = 0;        // kR of the instantiation for any R
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
  kWriteBack, kPlacements, kPops, kTotal, kShardExchange, kPhaseSlots
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

// The kAnyR drain's sum of resource dim d over the tasks it placed, the
// job's tasks start + from .. start + to - 1 (the register path sums them
// as it places).
__device__ __forceinline__ int drain_sum(const SolveArgs& a, int start, int from,
                                         int to, int d) {
  int sum = 0;
  for (int k = from; k < to; ++k) {
    int t = wadd(start, k);
    t = t < 0 ? 0 : (t > a.p - 1 ? a.p - 1 : t);
    sum = wadd(sum, a.task_data[(size_t)t * a.task_width + a.res + d]);
  }
  return sum;
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

// The exchange buffer of shard mode: word 0 is the abort word; slot
// (parity p, shard s) is the 64-byte line 1 + p * shards + s: key, tag.
constexpr int kSlotWords = 8;
__device__ __forceinline__ long long* xslot(const SolveArgs& a, int par, int s) {
  return a.xchg + (size_t)kSlotWords * (1 + par * a.shards + s);
}
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ long long ld_acquire_sys(const long long* p) {
  long long v;
  asm volatile("ld.acquire.sys.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ long long ld_relaxed_sys(const long long* p) {
  long long v;
  asm volatile("ld.relaxed.sys.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_relaxed_sys(long long* p, long long v) {
  asm volatile("st.relaxed.sys.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ void st_release_sys(long long* p, long long v) {
  asm volatile("st.release.sys.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// Warp 0 of CTA 0: publish this shard's key of exchange `seq` (lane 0),
// then acquire every shard's key (lane s polls shard s) and return their
// max to every lane; false when the spin ran past the deadline or another
// shard raised the abort word (then it is raised).
__device__ bool shard_exchange(const SolveArgs& a, int lane, int seq, long long* best) {
  const int par = seq & 1;
  const long long tag = ((long long)a.epoch << 32) | (unsigned)seq;
  if (lane == 0) {
    long long* mine = xslot(a, par, a.shard);
    st_relaxed_sys(mine, *best);
    st_release_sys(mine + 1, tag);
  }
  bool ok = true;
  long long got = LLONG_MIN;
  if (lane < a.shards) {
    const long long* slot = xslot(a, par, lane);
    const unsigned long long deadline = global_ns() + 1000000ull * (unsigned)a.spin_ms;
    for (;;) {
      if (ld_acquire_sys(slot + 1) == tag) {
        got = ld_relaxed_sys(slot);
        break;
      }
      if (ld_relaxed_sys(a.xchg) != 0 || global_ns() > deadline) {
        ok = false;
        break;
      }
    }
  }
  ok = __all_sync(kFull, ok);
  if (!ok && lane == 0) st_release_sys(a.xchg, 1);
  *best = warp_max(got);
  return ok;
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

// kR: the resource dims the task loops unroll (2 when r <= 2, kMaxR when
// r <= kMaxR), with the task's request and the drain sums in registers;
// kAnyR for any r: the scan reads the task from global memory (one
// broadcast load per dim, L1-resident) and the write-back sums the drain
// from the job's tasks.  kOnChip: every node row and the queue piece are
// in shared memory.  kShard: shard mode (shards > 1), compiled apart so
// the single-device instantiations carry none of its code or registers.
template <typename T, bool kStamp, int kR, bool kOnChip, bool kShard>
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
  constexpr bool sharded = kShard;
  const int gbase = (kShard ? a.node_off : 0) + base;  // first global node
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
  // [2][32]: words 0 .. 2r the next task; in shard mode 24 .. 27 the
  // cross-shard (max, ok) that CTA 0 sends, 28 .. 29 its mbarrier.
  int32_t* tbuf = reinterpret_cast<int32_t*>(xbar + 2);
  int32_t* pop_sm = tbuf + 64;  // the pop's result, published by warp 0
  // The static job rows the pops read (start .. uid rank).
  const int js_rows = a.juid + 1;
  T* js_sm = reinterpret_cast<T*>(pop_sm + 8);
  const T* jsta = a.jsta_smem ? js_sm : static_cast<const T*>(a.jsta);
  // The queue piece: the static queue rows the pops read (ts, uid rank,
  // exists, deserved floats), the dynamic copy, the job cache
  // (jcache[q * kWarps + w] is warp w's first active job of queue q, -1
  // if none), qshare[q] (queue q's share, kept current) and the deserved
  // quanta.  Off chip (many queues), the static rows and the quanta are
  // read where the wrapper built them, and the CTA's copy, job cache and
  // shares live in its piece of the scratch.  kOnChip implies the queue
  // piece on chip, so that instantiation's pointers below are all shared
  // ones and compile to shared-memory loads; the node rows' cursor is
  // carved from shared pointers in both cases for the same reason.
  const bool q_on = kOnChip || a.queue_smem;
  const int qs_rows = a.qdesf + r;
  T* qs_sm = a.jsta_smem ? js_sm + js_rows * J : js_sm;
  int32_t* qw_sm = reinterpret_cast<int32_t*>(qs_sm + qs_rows * Q);
  int32_t* qdes_sm = qw_sm + (qw_rows + kWarps) * Q + Q;  // after jcache, qshare
  const int jpiece = (jw_rows + 1) * J;
  int32_t* gj = a.scratch + (size_t)a.rows * n;  // [C][jpiece]
  const int qpiece = (qw_rows + kWarps + 1) * Q;
  int32_t* gq = gj + (size_t)C * jpiece;         // [C][qpiece] when off chip
  const T* qsta = q_on ? qs_sm : static_cast<const T*>(a.qsta);
  int32_t* qw = q_on ? qw_sm : gq + (size_t)rank * qpiece;
  int32_t* jcache = qw + qw_rows * Q;
  float* qshare = reinterpret_cast<float*>(jcache + kWarps * Q);
  const int32_t* qdes = q_on ? qdes_sm : a.qdes;
  int32_t* cursor = q_on ? qdes_sm + r * Q : reinterpret_cast<int32_t*>(qs_sm);
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
  if (q_on) {
    for (int i = tid; i < qs_rows * Q; i += kThreads)
      qs_sm[i] = static_cast<const T*>(a.qsta)[i];
    for (int i = tid; i < r * Q; i += kThreads) qdes_sm[i] = a.qdes[i];
  }
  for (int t = rank * kThreads + tid; t < a.p; t += C * kThreads) {
    a.out[4 * t + 0] = -1;
    a.out[4 * t + 1] = 0;
    a.out[4 * t + 2] = -1;
    a.out[4 * t + 3] = 0;
  }
  if (tid == 0) {
    for (int i = 0; i < 2; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(xbar + i)));
    if (kShard)
      for (int i = 0; i < 2; ++i)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                     ::"r"(smem_u32(tbuf + 32 * i + 28)));
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // Every CTA of the cluster has started (its slots and mbarriers may be
  // used) and every copy above is visible.
  cluster.sync();
  uint32_t xphase = 0;  // bit p: the phase parity mbarrier p completes next
  uint32_t gphase = 0;  // the same for the cross-shard broadcast's mbarriers
  for (int q = tid; q < Q; q += kThreads) qshare[q] = queue_share(a, qsta, qw, q);
  for (int q = 0; q < Q; ++q) {
    const int best = warp_best_job(a, jsta, jw, jshare, job_keys, q).idx;
    if (lane == 0) jcache[q * kWarps + warp] = best;
  }

  bool act = false;
  for (int q = tid; q < Q; q += kThreads) act |= qw[a.qact * Q + q] > 0;
  bool any_active = __syncthreads_or(act);
  int step = 0, par = 0, cur_sig = -1;
  int xseq = 0;          // shard mode: exchanges so far
  bool aborted = false;  // shard mode: the cross-shard exchange failed

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
    constexpr int kRegs = kR > 0 ? kR : 2;
    const int ptr0 = ptr;  // the drain places tasks start + ptr0 .. start + ptr - 1
    int dres[kRegs];
#pragma unroll
    for (int d = 0; d < kRegs; ++d) dres[d] = 0;
    // The task of the first placement comes from global memory; each
    // placement's warp 0 fetches the next task (the job's next, which the
    // drain reaches only if this placement succeeds) into tbuf while the
    // scan runs, and its arrival on the exchange mbarrier publishes it.
    int t = 0, sig = 0;
    int req[kRegs], res[kRegs];
    if (ptr < count_j) {
      t = wadd(start, ptr);
      t = t < 0 ? 0 : (t > a.p - 1 ? a.p - 1 : t);
      const int32_t* task = a.task_data + (size_t)t * a.task_width;
      if constexpr (kR > 0) {
#pragma unroll
        for (int d = 0; d < kR; ++d) {
          req[d] = d < r ? task[a.req + d] : 0;
          res[d] = d < r ? task[a.res + d] : 0;
        }
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
      if (kR > 0 && warp == 0 && lane <= 2 * r) {
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

      if constexpr (kR == kAnyR) {  // the grid score reads res[0], res[1]
        res[0] = task[a.res];
        res[1] = r > 1 ? task[a.res + 1] : 0;
      }
      long long best = LLONG_MIN;
      for (int li = tid; li < mine_n; li += kThreads) {
        bool fit_idle = true, fit_rel = true;
        if constexpr (kR > 0) {
#pragma unroll
          for (int d = 0; d < kR; ++d) {
            if (d < r) {
              const bool low = d >= 2 && req[d] <= kEps;
              fit_idle = fit_idle & (low | eps_le(req[d], row(rx.idle + d)[li]));
              fit_rel = fit_rel & (low | eps_le(req[d], row(rx.rel + d)[li]));
            }
          }
        } else {
          for (int d = 0; d < r; ++d) {
            const int rq = task[a.req + d];
            const bool low = d >= 2 && rq <= kEps;
            fit_idle = fit_idle & (low | eps_le(rq, row(rx.idle + d)[li]));
            fit_rel = fit_rel & (low | eps_le(rq, row(rx.rel + d)[li]));
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
        const long long key = pack_key(score, gbase + li, fit_idle, fit_rel);
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
        if (kR > 0 && lane <= 2 * r) tb[lane] = next;
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
      if (sharded) {  // every shard's key: the mesh's pmax / pmin
        // CTA 0 polls the shards and sends (max, ok) to every CTA of the
        // cluster, itself included: one decision for the whole cluster.
        int32_t* gb = tbuf + 32 * (xseq & 1);
        long long* gx = reinterpret_cast<long long*>(gb + 24);
        const uint32_t gbar = smem_u32(gb + 28);
        if (warp == 0) {
          if (lane == 0) arrive_expect(gbar, 2 * sizeof(long long));
          if (rank == 0) {
            const bool ok = shard_exchange(a, lane, xseq, &best);
            if (lane < C) {
              store_async(map_rank(smem_u32(gx), lane), best, map_rank(gbar, lane));
              store_async(map_rank(smem_u32(gx + 1), lane), ok ? 1 : 0,
                          map_rank(gbar, lane));
            }
          }
        }
        wait_parity(gbar, (gphase >> (xseq & 1)) & 1u);
        gphase ^= 1u << (xseq & 1);
        best = gx[0];
        const bool ok = gx[1] != 0;
        xseq += 1;
        if (!ok) {
          aborted = true;
          break;
        }
        st.mark(kShardExchange);
      }

      const int best_score = (int)(unsigned)((unsigned long long)best >> 32);
      const unsigned lo = (unsigned)((unsigned long long)best & 0xffffffffull);
      const int pick = (int)(0x3fffffffu - (lo >> 2));
      const bool feasible_any = best_score > kNegScore;
      const bool alloc_ok = feasible_any && (lo & 2u);
      const bool pipe_ok = feasible_any && !(lo & 2u) && (lo & 1u);
      const bool placed = alloc_ok || pipe_ok;

      const int li = pick - gbase;
      if (sharded && placed && rank == 0 && tid == 0) {
        // Every shard records the placement (the outputs are replicated).
        a.out[4 * t + 0] = pick;
        a.out[4 * t + 1] = alloc_ok ? 1 : 2;
        a.out[4 * t + 2] = dstep;
        a.out[4 * t + 3] = 0;
      }
      if (placed && li >= 0 && li < mine_n && li % kThreads == tid) {
        // The owner of the chosen node: rank-1 update of its column.
        for (int d = 0; d < r; ++d) {
          int32_t* idle = row(rx.idle + d) + li;
          int32_t* rel = row(rx.rel + d) + li;
          int32_t* used = row(rx.used + d) + li;
          const int rs = kR > 0 ? res[d] : task[a.res + d];
          if (alloc_ok) *idle = wsub(*idle, rs);
          if (pipe_ok) *rel = wsub(*rel, rs);
          *used = wadd(*used, rs);
        }
        row(rx.cnt)[li] = wadd(row(rx.cnt)[li], 1);
        if (!sharded) {
          a.out[4 * t + 0] = pick;
          a.out[4 * t + 1] = alloc_ok ? 1 : 2;
          a.out[4 * t + 2] = dstep;
          a.out[4 * t + 3] = 0;
        }
        for (int k = 0; k < rx.np_use; ++k) row(rx.port + k)[li] |= task[a.ports + k];
        for (int s = 0; s < rx.ns_use; ++s)
          row(rx.sel + s)[li] = wadd(row(rx.sel + s)[li], task[a.match + s]);
      }
      st.mark(kOwnerUpdate);
      if (placed) {
        ptr += 1;
        dstep += 1;
        if constexpr (kR > 0) {
#pragma unroll
          for (int d = 0; d < kR; ++d)
            if (d < r) dres[d] = wadd(dres[d], res[d]);
        }
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
      if constexpr (kR > 0) {
#pragma unroll
        for (int d = 0; d < kR; ++d) {
          req[d] = d < r ? tb[d] : 0;
          res[d] = d < r ? tb[r + d] : 0;
        }
        sig = tb[2 * r];
      } else {
        sig = a.task_sig[tn];
      }
    }

    if (aborted) break;  // uniform: every CTA of the cluster got CTA 0's ok

    // ---- write-back and rotation, on every CTA's own copy ---------------
    step = dstep;
    // The pop barrier stands between the pops' reads and these writes.
    if (!retire) {
      if (tid == j % kThreads) {  // the job's owner thread
        for (int d = 0; d < r; ++d)
          jw[(a.jalloc + d) * J + j] = wadd(
              jw[(a.jalloc + d) * J + j],
              kR > 0 ? dres[d] : drain_sum(a, start, ptr0, ptr, d));
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
          qw[(a.qalloc + d) * Q + q] = wadd(
              qw[(a.qalloc + d) * Q + q],
              kR > 0 ? dres[d] : drain_sum(a, start, ptr0, ptr, d));
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
    if (tid == 0) *a.steps = aborted ? -1 : step;
  }
  if (aborted)  // a poisoned result: the fetch raises DeviceFailure
    for (int t = rank * kThreads + tid; t < a.p; t += C * kThreads) a.out[4 * t + 1] = -1;
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
  if (a.queue_smem)
    b += (size_t)(a.qact + 2 + kWarps + a.r) * a.qdim * sizeof(int32_t) +
         (size_t)(a.qdesf + a.r) * a.qdim * sizeof(T);
  b += (size_t)a.smem_rows * a.slice * sizeof(int32_t);
  if (a.jwork_smem) b += (size_t)(a.jact + 2) * a.jdim * sizeof(int32_t);
  return b;
}

// One instantiation's launch, or with `clusters` set only the number of
// its clusters the card can run at once (cudaOccupancyMaxActiveClusters).
template <typename T, bool kStamp, int kR, bool kOnChip, bool kShard>
int launch(const SolveArgs& a, cudaStream_t s, int* clusters) {
  auto kernel = solve_session<T, kStamp, kR, kOnChip, kShard>;
  const int rows = 3 * a.r + 6 + (a.has_ports ? a.np_pad : 0) +
                   (a.has_pod_affinity || a.has_pod_affinity_score ? a.ns_pad : 0);
  if ((size_t)a.smem_bytes != smem_bytes<T>(a) || a.rows != rows || a.cluster < 1 ||
      a.cluster > 16 || (size_t)a.slice * a.cluster < (size_t)a.n ||
      a.shards < 1 || a.shard < 0 || a.shard >= a.shards || a.shards > 32 ||
      (a.shards > 1) != kShard ||
      (kShard && clusters == nullptr && (a.xchg == nullptr || a.spin_ms < 1)) ||
      (kR > 0 && (a.r > kR || 2 * a.r + 1 > 32)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem_bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (a.cluster > 8) {  // 16 CTAs: Hopper's non-portable cluster size
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess && clusters != nullptr) {  // a card without it hosts no 16
      cudaGetLastError();
      *clusters = 0;
      return 0;
    }
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
  int active = 0;
  e = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (clusters != nullptr) {
    // A size the card refuses outright is a capacity of 0, not an error.
    *clusters = e == cudaSuccess ? active : 0;
    if (e != cudaSuccess) cudaGetLastError();
    return 0;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (active < 1) return kNoCluster;
  e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Each instantiation behind one function of external linkage, so that a
// build compiles them in separate units in parallel and links the units
// (ops/cuda_solver.build_kernel): a unit, built with KBT_UNIT_T,
// KBT_UNIT_STAMP, KBT_UNIT_CHIP and KBT_UNIT_SHARD, defines the three kR
// instantiations of one (T, kStamp, kOnChip, kShard); the entry unit,
// built without them, dispatches to the 24 of its library and carries
// the C interface.  Shard mode is a library of its own, its entry built
// with KBT_ENTRY_SHARD and built only at the first sharded solve
// (ops/cuda_solver.build_shard_kernel): a host that never shards never
// compiles it.
template <typename T, bool kStamp, int kR, bool kOnChip, bool kShard>
int launch_instance(const SolveArgs& a, cudaStream_t s, int* clusters);

#ifdef KBT_UNIT_T

template <typename T, bool kStamp, int kR, bool kOnChip, bool kShard>
int launch_instance(const SolveArgs& a, cudaStream_t s, int* clusters) {
  return launch<T, kStamp, kR, kOnChip, kShard>(a, s, clusters);
}

template int launch_instance<KBT_UNIT_T, KBT_UNIT_STAMP, 2, KBT_UNIT_CHIP,
                             KBT_UNIT_SHARD>(const SolveArgs&, cudaStream_t, int*);
template int launch_instance<KBT_UNIT_T, KBT_UNIT_STAMP, kMaxR, KBT_UNIT_CHIP,
                             KBT_UNIT_SHARD>(const SolveArgs&, cudaStream_t, int*);
template int launch_instance<KBT_UNIT_T, KBT_UNIT_STAMP, kAnyR, KBT_UNIT_CHIP,
                             KBT_UNIT_SHARD>(const SolveArgs&, cudaStream_t, int*);

#else

#ifdef KBT_ENTRY_SHARD
constexpr bool kEntryShard = true;
#else
constexpr bool kEntryShard = false;
#endif

namespace {

template <typename T, bool kStamp, bool kShard>
int launch_for_mode(const SolveArgs& a, cudaStream_t s, int* clusters) {
  const bool on_chip = a.smem_rows == a.rows && a.queue_smem;
  if (a.r <= 2)
    return on_chip ? launch_instance<T, kStamp, 2, true, kShard>(a, s, clusters)
                   : launch_instance<T, kStamp, 2, false, kShard>(a, s, clusters);
  if (a.r <= kMaxR)
    return on_chip ? launch_instance<T, kStamp, kMaxR, true, kShard>(a, s, clusters)
                   : launch_instance<T, kStamp, kMaxR, false, kShard>(a, s, clusters);
  return on_chip ? launch_instance<T, kStamp, kAnyR, true, kShard>(a, s, clusters)
                 : launch_instance<T, kStamp, kAnyR, false, kShard>(a, s, clusters);
}

template <bool kStamp>
int dispatch(const SolveArgs& a, int use_f64, cudaStream_t s, int* clusters) {
  return use_f64 ? launch_for_mode<double, kStamp, kEntryShard>(a, s, clusters)
                 : launch_for_mode<float, kStamp, kEntryShard>(a, s, clusters);
}

}  // namespace

extern "C" int kbt_solve_session(const SolveArgs* args, int use_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return args->stamps != nullptr ? dispatch<true>(*args, use_f64, s, nullptr)
                                 : dispatch<false>(*args, use_f64, s, nullptr);
}

// How many clusters of this plan the card can run at once (0: it cannot
// host the plan's cluster at the plan's shared memory), asked of the
// library's unstamped instantiation.  `args` needs its shapes, plan,
// conf, layout and shard count; its pointers are not read.
extern "C" int kbt_cluster_capacity(const SolveArgs* args, int use_f64, int* clusters) {
  return dispatch<false>(*args, use_f64, nullptr, clusters);
}

#ifdef KBT_ENTRY_SHARD
// Shard mode's exchange buffer: pinned host memory mapped into every
// device (with unified addressing its device pointer serves them all),
// zeroed.
extern "C" int kbt_xchg_alloc(size_t bytes, void** host, void** dev) {
  cudaError_t e = cudaHostAlloc(host, bytes, cudaHostAllocMapped | cudaHostAllocPortable);
  if (e != cudaSuccess) return static_cast<int>(e);
  memset(*host, 0, bytes);
  return static_cast<int>(cudaHostGetDevicePointer(dev, *host, 0));
}

// A stream of its own for one shard of the mesh on `device`, which no
// other work shares: the shards of one solve must run at once.
extern "C" int kbt_stream_create(int device, void** out) {
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = nullptr;
  e = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  cudaSetDevice(prev);
  *out = s;
  return static_cast<int>(e);
}
#endif

extern "C" const char* kbt_error_string(int code) {
  if (code == kNoCluster)
    return "no group of SMs can host the thread-block cluster "
           "(cudaOccupancyMaxActiveClusters returned 0)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

#endif  // KBT_UNIT_T
