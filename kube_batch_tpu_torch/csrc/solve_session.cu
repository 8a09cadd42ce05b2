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
// dependent steps, each one scan over N nodes plus one block-wide
// reduction to pick the node, and the next step reads the node state the
// previous one wrote.  The input and output bytes (a few MB) would take
// microseconds at 3.35 TB/s.
//
// What this first design does about it: it keeps the whole chain inside
// ONE persistent block of 1024 threads, so no step pays a kernel launch or
// a host round trip.  The node state (about 0.7 MB at 10k nodes) lives in
// global memory and stays in L2.  Node i belongs to thread i % 1024: the
// thread scans its nodes for feasibility and score, a warp-shuffle plus
// shared-memory reduction finds (max score, min index), and the owner of
// the chosen node applies the rank-1 update itself, so the next scan sees
// it without an extra barrier.  Job and queue pops are block-wide
// lexicographic reductions over [J] and [Q].  Spreading the node state over
// a thread-block cluster (DSMEM) or several blocks is later work.
//
// Exactness, each point from the reference:
//  (a) ties break to the first index: max score, then the minimum node
//      index; lexicographic pops take the minimum index among equal keys;
//  (b) every integer sum is int32 and wraps (w* helpers below);
//  (c) the grid-score division is in the float key type and the share
//      division in float32, both IEEE-rounded: build WITHOUT
//      --use_fast_math;
//  (d) an empty pop mask gives index `dim`, which retires the queue;
//  (e) the kernel writes only the buffers the wrapper has just built;
//  (f) the conf's key orders, flags and weights are launch arguments.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

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
  // shapes
  int32_t n, p, jdim, qdim, r, np_pad, ns_pad, n_sig;
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

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 8;        // ops/cuda_solver.py MAX_R
constexpr int kMaxKeys = 5;     // up to 3 conf keys, then ts and uid rank
constexpr int kEps = 10;        // EPS_QUANTA
constexpr int kGridK = 1 << 12;  // SCORE_GRID_K
constexpr int kNegScore = -2147483647;  // SCORE_NEG_INF
constexpr unsigned kFull = 0xffffffffu;
enum { kKeyNone = 0, kKeyPriority = 1, kKeyGang = 2, kKeyDrf = 3 };

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
  return l < m || wabs(wsub(l, m)) < kEps;
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
  if (a.idx < 0) return false;
  if (b.idx < 0) return true;
#pragma unroll
  for (int i = 0; i < kMaxKeys; ++i) {
    if (a.k[i] < b.k[i]) return true;
    if (b.k[i] < a.k[i]) return false;
  }
  return a.idx < b.idx;
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

// Every thread gets the block's lexicographic minimum.  The leading
// barrier frees the slots from the previous reduction.
template <typename T>
__device__ Lex<T> block_lex_min(Lex<T> v, Lex<T>* slots) {
  v = warp_lex_min(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_lex_min(slots[threadIdx.x & 31]);
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

__device__ long long block_max(long long v, long long* slots) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = v;
  __syncthreads();
  return warp_max(slots[threadIdx.x & 31]);
}

template <typename T>
__device__ __forceinline__ T job_key(const SolveArgs& a, const T* jsta,
                                     const T* total, int code, int j) {
  const int J = a.jdim;
  if (code == kKeyPriority) return -jsta[a.jprio * J + j];
  if (code == kKeyGang)
    return (T)a.jdyn[a.jready * J + j] >= jsta[a.jmin * J + j] ? (T)1 : (T)0;
  if (code == kKeyDrf) {
    float share = 0.0f;
    for (int i = 0; i < a.r; ++i) {
      float s = safe_share((float)a.jdyn[(a.jalloc + i) * J + j], (float)total[i]);
      share = s > share ? s : share;
    }
    return (T)share;
  }
  return (T)0;
}

template <typename T>
__device__ __forceinline__ float queue_share(const SolveArgs& a, const T* qsta, int q) {
  const int Q = a.qdim;
  float share = 0.0f;
  for (int i = 0; i < a.r; ++i) {
    float s = safe_share((float)a.qdyn[(a.qalloc + i) * Q + q],
                         (float)qsta[(a.qdesf + i) * Q + q]);
    share = s > share ? s : share;
  }
  return share;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) solve_session(const SolveArgs a) {
  __shared__ Lex<T> lex_slots[kWarps];
  __shared__ long long key_slots[kWarps];

  const int tid = threadIdx.x;
  const int n = a.n, J = a.jdim, Q = a.qdim, r = a.r;
  const T* jsta = static_cast<const T*>(a.jsta);
  const T* qsta = static_cast<const T*>(a.qsta);
  const T* sig_mask = static_cast<const T*>(a.sig_mask);
  const T* total = static_cast<const T*>(a.total);
  int32_t* nint = a.node_int;
  const int shift[2] = {a.score_shift[0], a.score_shift[1]};
  const int job_keys[3] = {a.job_key0, a.job_key1, a.job_key2};

  for (int t = tid; t < a.p; t += kThreads) {
    a.out[4 * t + 0] = -1;
    a.out[4 * t + 1] = 0;
    a.out[4 * t + 2] = -1;
    a.out[4 * t + 3] = 0;
  }
  bool mine = false;
  for (int q = tid; q < Q; q += kThreads) mine |= a.qdyn[a.qact * Q + q] > 0;
  bool any_active = __syncthreads_or(mine);
  int step = 0;

  while (any_active) {
    // ---- queue pop: lex-first active queue by share, ts, uid rank ------
    Lex<T> qc;
    qc.idx = -1;
    for (int q = tid; q < Q; q += kThreads) {
      if (a.qdyn[a.qact * Q + q] <= 0) continue;
      Lex<T> c;
      c.idx = q;
      c.k[0] = a.queue_key0 ? (T)queue_share(a, qsta, q) : (T)0;
      c.k[1] = qsta[a.qts * Q + q];
      c.k[2] = qsta[a.quid * Q + q];
      c.k[3] = (T)0;
      c.k[4] = (T)0;
      if (lex_before(c, qc)) qc = c;
    }
    qc = block_lex_min(qc, lex_slots);
    const int q = qc.idx < 0 ? Q : qc.idx;

    bool overused = false;
    if (a.has_proportion) {
      overused = true;
      for (int i = 0; i < r; ++i) {
        const int des = q < Q ? a.qdes[i * Q + q] : 0;
        const int alc = q < Q ? a.qdyn[(a.qalloc + i) * Q + q] : 0;
        bool ok = eps_le(des, alc);
        if (i >= 2) ok = ok || des <= kEps;
        overused = overused && ok;
      }
    }

    // ---- job pop: the conf's tiered keys, then ts, then uid rank -------
    Lex<T> jc;
    jc.idx = -1;
    const T qf = (T)q;
    for (int j = tid; j < J; j += kThreads) {
      if (a.jdyn[a.jact * J + j] <= 0 || !(jsta[a.jqueue * J + j] == qf)) continue;
      Lex<T> c;
      c.idx = j;
#pragma unroll
      for (int s = 0; s < 3; ++s) c.k[s] = job_key(a, jsta, total, job_keys[s], j);
      c.k[3] = jsta[a.jts * J + j];
      c.k[4] = jsta[a.juid * J + j];
      if (lex_before(c, jc)) jc = c;
    }
    jc = block_lex_min(jc, lex_slots);
    const int j = jc.idx < 0 ? J : jc.idx;
    const bool has_job = j < J;
    const bool retire = overused || !has_job;

    const int start = has_job ? (int)jsta[a.jstart * J + j] : 0;
    const int count_j = retire ? 0 : (int)jsta[a.jcount * J + j];
    const int minavail = has_job ? (int)jsta[a.jmin * J + j] : 0;
    int ptr = has_job ? a.jdyn[a.jptr * J + j] : 0;
    int ready_cnt = has_job ? a.jdyn[a.jready * J + j] : 0;

    // ---- drain the popped job: one placement per iteration -------------
    bool survive = false;
    int dstep = step;
    int dres[kMaxR];
#pragma unroll
    for (int d = 0; d < kMaxR; ++d) dres[d] = 0;
    for (;;) {
      // Past the job's last task (always so for a retired pop) the
      // iteration places nothing and ends the drain: skip its scan.
      if (ptr >= count_j) {
        survive = false;
        break;
      }
      int t = wadd(start, ptr);
      t = t < 0 ? 0 : (t > a.p - 1 ? a.p - 1 : t);
      const int32_t* task = a.task_data + (size_t)t * a.task_width;
      int req[kMaxR], res[kMaxR];
#pragma unroll
      for (int d = 0; d < kMaxR; ++d) {
        req[d] = d < r ? task[a.req + d] : 0;
        res[d] = d < r ? task[a.res + d] : 0;
      }
      int sig = a.task_sig[t];
      sig = sig < 0 ? 0 : (sig > a.n_sig - 1 ? a.n_sig - 1 : sig);
      const T* sig_row = sig_mask + (size_t)sig * n;
      const int32_t* bonus_row = a.sig_bonus + (size_t)sig * n;

      long long best = LLONG_MIN;
      for (int i = tid; i < n; i += kThreads) {
        bool fit_idle = true, fit_rel = true;
#pragma unroll
        for (int d = 0; d < kMaxR; ++d) {
          if (d >= r) break;
          const bool low = d >= 2 && req[d] <= kEps;
          fit_idle = fit_idle && (low || eps_le(req[d], nint[(a.idle + d) * n + i]));
          fit_rel = fit_rel && (low || eps_le(req[d], nint[(a.rel + d) * n + i]));
        }
        bool feas = sig_row[i] > (T)0.5 && nint[a.exists * n + i] > 0 &&
                    nint[a.cnt * n + i] < nint[a.cap * n + i] && (fit_idle || fit_rel);
        if (feas && a.has_ports) {
          for (int k = 0; k < a.np_pad; ++k)
            if (task[a.ports + k] > 0 && a.nport[k * n + i] > 0) feas = false;
        }
        if (feas && a.has_pod_affinity) {
          for (int s = 0; s < a.ns_pad; ++s) {
            const bool have = a.nsel[s * n + i] > 0;
            if ((task[a.aff + s] > 0 && !have) || (task[a.anti + s] > 0 && have)) feas = false;
          }
        }
        int score = kNegScore;
        if (feas) {
          int g[2];
#pragma unroll
          for (int d = 0; d < 2; ++d) {
            const int cs = a.node_cs[d * n + i];
            int xs = lshr(wadd(nint[(a.used + d) * n + i], res[d]), shift[d]);
            xs = xs < cs ? xs : cs;
            const int quot = (int)((T)wmul(xs, kGridK) / (T)(cs > 1 ? cs : 1));
            g[d] = cs == 0 ? kGridK : quot;
          }
          score = 0;
          if (a.w_least5)
            score = wadd(score, wmul(a.w_least5, wsub(wsub(2 * kGridK, g[0]), g[1])));
          if (a.w_most5) score = wadd(score, wmul(a.w_most5, wadd(g[0], g[1])));
          if (a.w_bal)
            score = wadd(score, wmul(a.w_bal, wsub(10 * kGridK,
                                                   wmul(10, wabs(wsub(g[0], g[1]))))));
          if (a.has_pod_affinity_score) {
            for (int s = 0; s < a.ns_pad; ++s) {
              const int wd = wsub(task[a.paffw + s], task[a.pantiw + s]);
              score = wadd(score, wmul(wmul(kGridK, wd), a.nsel[s * n + i]));
            }
          }
          score = wadd(score, bonus_row[i]);
        }
        const long long key = pack_key(score, i, fit_idle, fit_rel);
        best = key > best ? key : best;
      }
      best = block_max(best, key_slots);

      const int best_score = (int)(unsigned)((unsigned long long)best >> 32);
      const unsigned lo = (unsigned)((unsigned long long)best & 0xffffffffull);
      const int pick = (int)(0x3fffffffu - (lo >> 2));
      const bool feasible_any = best_score > kNegScore;
      const bool alloc_ok = feasible_any && (lo & 2u);
      const bool pipe_ok = feasible_any && !(lo & 2u) && (lo & 1u);
      const bool placed = alloc_ok || pipe_ok;

      if (placed && pick % kThreads == tid) {
        // The owner of the chosen node: rank-1 update of its column.
        for (int d = 0; d < r; ++d) {
          int* idle = &nint[(a.idle + d) * n + pick];
          int* rel = &nint[(a.rel + d) * n + pick];
          int* used = &nint[(a.used + d) * n + pick];
          if (alloc_ok) *idle = wsub(*idle, res[d]);
          if (pipe_ok) *rel = wsub(*rel, res[d]);
          *used = wadd(*used, res[d]);
        }
        nint[a.cnt * n + pick] = wadd(nint[a.cnt * n + pick], 1);
        a.out[4 * t + 0] = pick;
        a.out[4 * t + 1] = alloc_ok ? 1 : 2;
        a.out[4 * t + 2] = dstep;
        a.out[4 * t + 3] = 0;
        if (a.has_ports)
          for (int k = 0; k < a.np_pad; ++k) a.nport[k * n + pick] |= task[a.ports + k];
        if (a.has_pod_affinity || a.has_pod_affinity_score)
          for (int s = 0; s < a.ns_pad; ++s)
            a.nsel[s * n + pick] = wadd(a.nsel[s * n + pick], task[a.match + s]);
      }
      if (placed) {
        ptr += 1;
        dstep += 1;
#pragma unroll
        for (int d = 0; d < kMaxR; ++d)
          if (d < r) dres[d] = wadd(dres[d], res[d]);
      }
      if (alloc_ok) ready_cnt += 1;
      const bool ready = a.has_gang ? ready_cnt >= minavail : true;
      const bool remaining = ptr < count_j;
      if (!feasible_any || ready || !remaining) {
        survive = feasible_any && ready && remaining;
        break;
      }
    }

    // ---- write-back and rotation ---------------------------------------
    step = dstep;
    if (tid == 0) {
      if (!retire) {
        for (int d = 0; d < r; ++d) {
          a.jdyn[(a.jalloc + d) * J + j] = wadd(a.jdyn[(a.jalloc + d) * J + j], dres[d]);
          if (q < Q)
            a.qdyn[(a.qalloc + d) * Q + q] = wadd(a.qdyn[(a.qalloc + d) * Q + q], dres[d]);
        }
        a.jdyn[a.jptr * J + j] = ptr;
        a.jdyn[a.jready * J + j] = ready_cnt;
        a.jdyn[a.jact * J + j] = survive ? 1 : 0;
      } else if (q < Q) {
        a.qdyn[a.qact * Q + q] = 0;
      }
    }
    __syncthreads();
    mine = false;
    for (int qq = tid; qq < Q; qq += kThreads) mine |= a.qdyn[a.qact * Q + qq] > 0;
    any_active = __syncthreads_or(mine);
  }
  if (tid == 0) *a.steps = step;
}

}  // namespace

extern "C" int kbt_solve_session(const SolveArgs* args, int use_f64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_f64)
    solve_session<double><<<1, kThreads, 0, s>>>(*args);
  else
    solve_session<float><<<1, kThreads, 0, s>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
