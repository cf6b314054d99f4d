// Fused core-dynamics step + observation for batched MiniGrid envs, on Hopper.
//
// Replaces minigrid_tpu/ops/fused_step.py::_kernel (the Pallas TPU kernel
// launched by fused_rollout). It computes the same function: for each env,
// T steps of the core transition (turn/move, goal reward, lava termination,
// pickup/drop/door toggle/box contents with the grid write, truncation at
// max_steps), and after each step the egocentric V x V window, the
// visibility flood on the raw window, the carried-object overlay and the
// mask to the 9 observation bits (or the see-through-walls mask). A second
// entry takes one broadcast reset row per step (packed grid + scalars): envs
// that finish the step (terminated | truncated) take the row after the
// transition and before the observation, the order of the JAX package's
// envs/base.py::_apply_broadcast_reset.
//
// Design: one thread per env, one warp of 32 envs per block (a sweep over
// 32/64/128 envs per block on the H100 favoured 32: B=4096 then spreads over
// 128 SMs instead of 32). The block keeps its envs' packed grids in shared
// memory laid out [cell][env], so thread t touches only smem[c * 32 + t]:
// no bank conflicts. The scalars stay in registers across the T steps, so
// the state crosses device memory once per launch. The one-hot contractions
// of the TPU kernel become direct indexed shared-memory reads (1 for the
// front cell, V*V for the window); the visibility flood stays the per-row
// bit-packed Kogge-Stone recurrence of core/visibility.py in 32-bit integer
// registers. The kernel reads and writes the public EnvState tensors (grid
// (B, W, H, 5) uint8 and friends) directly, so a rollout that calls it once
// per step needs no layout conversion around it. Device-memory traffic is
// coalesced through a staging area of one row per env in shared memory (an
// odd number of words, so per-thread row access is conflict-free): the
// block's contiguous grid bytes are copied in and out by the whole warp,
// and each step's (B, V*V) observation rows are gathered there and written
// out as one contiguous run.
//
// Bound: bytes. Per launch it reads the state (B * (W*H*5 + 21) bytes) and
// writes it back with its two flags (B * (W*H*5 + 23)), reads T * B int32 actions and writes
// T * B * (4*V*V + 4 + 2) bytes of observations, rewards and flags; the
// arithmetic per byte is a few integer operations. At B=4096, DoorKey-8x8
// (W*H=64), V=7: T=1 with a reset row moves ~3.64 MB (~1.09 us at
// 3.35 TB/s), T=128 ~110.8 MB (~33.1 us). At T=1 the launch overhead is
// larger than the bound; the T-step entry keeps the state out of device
// memory between steps.
//
// Float rule: the reward is 1 - 0.9 * (step_count / max_steps) rounded after
// each operation (__fdiv_rn, __fmul_rn, __fsub_rn, and the build passes
// -fmad=false), so it is bit-identical to the plain PyTorch version.
//
// Built with nvcc into a shared library with a plain C interface, loaded
// with ctypes (minigrid_tpu_torch/ops/fused_step.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kEmpty = 1, kWall = 2, kFloor = 3, kDoor = 4, kKey = 5,
              kBall = 6, kBox = 7, kGoal = 8, kLava = 9;
constexpr int kOpen = 0, kClosed = 1, kLocked = 2;
constexpr int kWallPacked = kWall | (5 << 4);  // grey wall
constexpr int kNScal = 8;  // x, y, dir, carrying, step_count, term, trunc, pad

struct Args {
  const uint8_t* grid_in;    // (B, W, H, 5)
  const int32_t* pos_in;     // (B, 2)
  const int32_t* dir_in;     // (B,)
  const uint8_t* carry_in;   // (B, 5)
  const int32_t* step_in;    // (B,)
  const int32_t* actions;    // (T, B)
  const int32_t* reset_grid; // (T, W*H) packed cells, or null
  const int32_t* reset_scal; // (T, kNScal), or null
  int32_t* obs;              // (T, V*V, B) native or (T, B, V*V) public
  float* reward;             // (T, B)
  uint8_t* term;             // (T, B)
  uint8_t* trunc;            // (T, B)
  uint8_t* grid_out;         // (B, W, H, 5)
  int32_t* pos_out;          // (B, 2)
  int32_t* dir_out;          // (B,)
  uint8_t* carry_out;        // (B, 5)
  int32_t* step_out;         // (B,)
  uint8_t* term_out;         // (B,)
  uint8_t* trunc_out;        // (B,)
  int B, T, W, H, max_steps, see_through, native_layout;
};

__device__ __forceinline__ int pack5(const uint8_t* c) {
  return c[0] | (c[1] << 4) | (c[2] << 7) | (c[3] << 9) | (c[4] << 13);
}

__device__ __forceinline__ void unpack5(int p, uint8_t* c) {
  c[0] = p & 15;
  c[1] = (p >> 4) & 7;
  c[2] = (p >> 7) & 3;
  c[3] = (p >> 9) & 15;
  c[4] = (p >> 13) & 7;
}

constexpr int kEnvs = 32;  // envs (threads) per block

// Words in one env's staging row: its grid bytes or its V*V observation
// words, whichever is more, rounded up to an odd count.
__host__ __device__ inline int stage_words(int num_cells, int view_size) {
  const int grid_words = (num_cells * 5 + 3) / 4;
  const int obs_words = view_size * view_size;
  const int w = grid_words > obs_words ? grid_words : obs_words;
  return w | 1;
}

// Copy n rows of rb bytes between a contiguous global run and the staging
// rows (stride rs words), with the whole warp, kBatch independent loads in
// flight per thread: 4-byte words when rows and the global base are
// word-aligned, else bytes.
constexpr int kBatch = 8;

template <bool TO_STAGE, typename T>
__device__ __forceinline__ void copy_run(T* global, T* stage, int n, int rl,
                                         int rs) {
  const int total = n * rl;
  for (int w0 = threadIdx.x; w0 < total; w0 += kBatch * kEnvs) {
    T v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int w = w0 + k * kEnvs;
      const int e = w / rl;
      if (w < total) v[k] = TO_STAGE ? global[w] : stage[e * rs + w - e * rl];
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int w = w0 + k * kEnvs;
      const int e = w / rl;
      if (w < total) {
        if (TO_STAGE) stage[e * rs + w - e * rl] = v[k];
        else global[w] = v[k];
      }
    }
  }
}

template <bool TO_STAGE>
__device__ void copy_rows(uint8_t* global, int* stage, int n, int rb, int rs) {
  if (rb % 4 == 0 && (reinterpret_cast<uintptr_t>(global) & 3) == 0)
    copy_run<TO_STAGE>(reinterpret_cast<int*>(global), stage, n, rb / 4, rs);
  else
    copy_run<TO_STAGE>(global, reinterpret_cast<uint8_t*>(stage), n, rb,
                       rs * 4);
}

// One env's grid between its staging row (5 bytes per cell) and its packed
// cells in shared memory (cell c at g[c * kEnvs]); the two never overlap.
__device__ __forceinline__ void pack_row(const uint8_t* __restrict__ row,
                                         int* __restrict__ g, int nc) {
#pragma unroll 8
  for (int c = 0; c < nc; ++c) g[c * kEnvs] = pack5(row + 5 * c);
}

__device__ __forceinline__ void unpack_row(const int* __restrict__ g,
                                           uint8_t* __restrict__ row, int nc) {
#pragma unroll 8
  for (int c = 0; c < nc; ++c) unpack5(g[c * kEnvs], row + 5 * c);
}

template <int V, bool RESET>
__global__ void __launch_bounds__(kEnvs) fused_step_kernel(Args a) {
  extern __shared__ int smem[];
  constexpr int hs = V / 2, VV = V * V, full = (1 << V) - 1;
  const int tid = threadIdx.x;
  const long long B = a.B;
  const long long b0 = (long long)blockIdx.x * kEnvs;
  const long long b = b0 + tid;
  const int n = (int)(B - b0 < kEnvs ? B - b0 : kEnvs);  // ragged last block
  const bool active = tid < n;
  const int W = a.W, H = a.H, NC = W * H, RB = NC * 5;
  const int RS = stage_words(NC, V);
  int* g = smem + tid;            // this env's grid: cell c at g[c * kEnvs]
  int* stage = smem + NC * kEnvs;  // kEnvs staging rows of RS words
  int* my_stage = stage + tid * RS;

  // --- state in: grid bytes through the staging rows, scalars direct ----
  copy_rows<true>(const_cast<uint8_t*>(a.grid_in) + b0 * RB, stage, n, RB,
                  RS);
  __syncthreads();
  int x = 0, y = 0, d = 0, carry = kEmpty, sc = 0, te = 0, tr = 0;
  if (active) {
    pack_row(reinterpret_cast<const uint8_t*>(my_stage), g, NC);
    x = a.pos_in[2 * b];
    y = a.pos_in[2 * b + 1];
    d = a.dir_in[b];
    carry = pack5(a.carry_in + 5 * b);
    sc = a.step_in[b];
  }
  __syncthreads();  // the staging rows now carry observations

  for (int t = 0; t < a.T; ++t) {
    if (active) {
      const int act = a.actions[(long long)t * B + b];
      sc += 1;
      // --- transition (core/step.py::step_core) -------------------------
      const int turn = act == 0 ? -1 : (act == 1 ? 1 : 0);
      const int nd = (d + turn + 4) & 3;
      const int fx = (d == 0) - (d == 2), fy = (d == 1) - (d == 3);
      const int fwx = x + fx, fwy = y + fy;
      const bool inb = fwx >= 0 && fwx < W && fwy >= 0 && fwy < H;
      const int fidx = fwx * H + fwy;
      const int fval = inb ? g[fidx * kEnvs] : kWallPacked;  // before write
      const int ftype = fval & 15, fcolor = (fval >> 4) & 7,
                fstate = (fval >> 7) & 3;
      const bool carrying = (carry & 15) != kEmpty;
      const bool can_overlap = ftype == kEmpty || ftype == kFloor ||
                               ftype == kGoal || ftype == kLava ||
                               (ftype == kDoor && fstate == kOpen);
      const bool fwd = act == 2;
      const bool move = fwd && can_overlap && inb;
      const bool hits_goal = fwd && ftype == kGoal;
      const bool terminated = hits_goal || (fwd && ftype == kLava);
      const float rew =
          hits_goal ? __fsub_rn(1.0f, __fmul_rn(0.9f, __fdiv_rn(
                                                    (float)sc,
                                                    (float)a.max_steps)))
                    : 0.0f;
      const bool do_pickup = act == 3 && !carrying &&
                             (ftype == kKey || ftype == kBall || ftype == kBox);
      const bool do_drop = act == 4 && ftype == kEmpty && carrying;
      const bool is_toggle = act == 5;
      const bool is_door = ftype == kDoor, is_box = ftype == kBox;
      const bool has_key =
          (carry & 15) == kKey && ((carry >> 4) & 7) == fcolor;
      const int toggled = fstate == kLocked
                              ? (has_key ? kOpen : kLocked)
                              : (fstate == kOpen ? kClosed : kOpen);
      const int door_cell = (fval & ~(3 << 7)) | (toggled << 7);
      const int cont_type = (fval >> 9) & 15, cont_color = (fval >> 13) & 7;
      const int contents =
          cont_type != 0 ? (cont_type | (cont_color << 4)) : kEmpty;
      int new_fwd = fval;
      if (do_pickup) new_fwd = kEmpty;
      if (do_drop) new_fwd = carry;
      if (is_toggle && is_door) new_fwd = door_cell;
      if (is_toggle && is_box) new_fwd = contents;
      if (inb && (do_pickup || do_drop || (is_toggle && (is_door || is_box))))
        g[fidx * kEnvs] = new_fwd;
      carry = do_pickup ? fval : (do_drop ? kEmpty : carry);
      if (move) { x = fwx; y = fwy; }
      d = nd;
      te = terminated;
      tr = sc >= a.max_steps;
      const long long o = (long long)t * B + b;
      a.reward[o] = rew;
      a.term[o] = te;
      a.trunc[o] = tr;

      // --- broadcast reset row into finished envs, before the obs ------
      if (RESET && (te || tr)) {
        const int32_t* rg = a.reset_grid + (long long)t * NC;
        for (int c = 0; c < NC; ++c) g[c * kEnvs] = rg[c];
        const int32_t* rs = a.reset_scal + (long long)t * kNScal;
        x = rs[0]; y = rs[1]; d = rs[2]; carry = rs[3]; sc = rs[4];
        te = rs[5]; tr = rs[6];
      }

      // --- observation on the new state (core/obs.py::gen_obs) ---------
      const int ofx = (d == 0) - (d == 2), ofy = (d == 1) - (d == 3);
      const int orx = -ofy, ory = ofx;
      const int tlx = x + ofx * (V - 1) - orx * hs;
      const int tly = y + ofy * (V - 1) - ory * hs;
      int u[VV];
#pragma unroll
      for (int vx = 0; vx < V; ++vx) {
#pragma unroll
        for (int vy = 0; vy < V; ++vy) {
          const int wx = tlx + orx * vx - ofx * vy;
          const int wy = tly + ory * vx - ofy * vy;
          const bool in = wx >= 0 && wx < W && wy >= 0 && wy < H;
          u[vx * V + vy] = in ? g[(wx * H + wy) * kEnvs] : kWallPacked;
        }
      }
      int rows[V];
      if (a.see_through) {
#pragma unroll
        for (int j = 0; j < V; ++j) rows[j] = full;
      } else {
        // visibility on the raw window (before the overlay): bit x of row
        // j = view cell (x, j); rows swept from the agent's row upwards
        int seed = 1 << hs;
#pragma unroll
        for (int j = V - 1; j >= 0; --j) {
          int tb = 0;
#pragma unroll
          for (int vx = 0; vx < V; ++vx) {
            const int c = u[vx * V + j];
            const int typ = c & 15;
            const bool opaque =
                typ == kWall || (typ == kDoor && ((c >> 7) & 3) != kOpen);
            tb |= (!opaque) << vx;
          }
          int m = seed;
          int T = (tb << 1) & full;
#pragma unroll
          for (int s = 1; s < V; s *= 2) {
            m |= (m << s) & T;
            T &= (T << s) & full;
          }
          const int m1 = m;
          int U = tb >> 1;
#pragma unroll
          for (int s = 1; s < V; s *= 2) {
            m |= (m >> s) & U;
            U &= U >> s;
          }
          rows[j] = m;
          const int e = m1 & tb & (full >> 1);
          const int f = m & tb & (full ^ 1);
          seed = (e | ((e << 1) & full)) | (f | (f >> 1));
        }
      }
      u[hs * V + V - 1] = carry;  // carried-object overlay
#pragma unroll
      for (int vx = 0; vx < V; ++vx) {
#pragma unroll
        for (int vy = 0; vy < V; ++vy) {
          const int k = vx * V + vy;
          const int val = ((rows[vy] >> vx) & 1) ? (u[k] & 0x1FF) : 0;
          if (a.native_layout)  // (T, V*V, B): already coalesced
            a.obs[((long long)t * VV + k) * B + b] = val;
          else
            my_stage[k] = val;
        }
      }
    }
    if (!a.native_layout) {
      // the block's (n, V*V) rows of step t are one contiguous run
      __syncthreads();
      int* dst = a.obs + ((long long)t * B + b0) * VV;
#pragma unroll 7
      for (int i = tid; i < n * VV; i += kEnvs) {
        const int e = i / VV;
        dst[i] = stage[e * RS + i - e * VV];
      }
      __syncthreads();
    }
  }

  // --- state out ---------------------------------------------------------
  if (active) {
    unpack_row(g, reinterpret_cast<uint8_t*>(my_stage), NC);
    a.pos_out[2 * b] = x;
    a.pos_out[2 * b + 1] = y;
    a.dir_out[b] = d;
    unpack5(carry, a.carry_out + 5 * b);
    a.step_out[b] = sc;
    a.term_out[b] = te;
    a.trunc_out[b] = tr;
  }
  __syncthreads();
  copy_rows<false>(a.grid_out + b0 * RB, stage, n, RB, RS);
}

template <int V, bool RESET>
int launch(const Args& a, cudaStream_t stream) {
  const int nc = a.W * a.H;
  const size_t smem = (size_t)(nc + stage_words(nc, V)) * kEnvs * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_step_kernel<V, RESET>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (a.B + kEnvs - 1) / kEnvs;
  fused_step_kernel<V, RESET><<<blocks, kEnvs, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool RESET>
int dispatch(const Args& a, int view_size, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (view_size) {
    case 3: return launch<3, RESET>(a, s);
    case 5: return launch<5, RESET>(a, s);
    case 7: return launch<7, RESET>(a, s);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns 0, -1 for an unsupported view size, or
// the CUDA error of the launch. The grid rows may be any size; shared
// memory above 48 KB per block is opted into (up to the card's limit).
int fused_step_launch(
    const void* grid_in, const void* pos_in, const void* dir_in,
    const void* carry_in, const void* step_in, const void* actions,
    const void* reset_grid, const void* reset_scal,
    void* obs, void* reward, void* term, void* trunc,
    void* grid_out, void* pos_out, void* dir_out, void* carry_out,
    void* step_out, void* term_out, void* trunc_out,
    int B, int T, int W, int H, int view_size, int max_steps,
    int see_through, int native_layout, void* stream) {
  Args a;
  a.grid_in = static_cast<const uint8_t*>(grid_in);
  a.pos_in = static_cast<const int32_t*>(pos_in);
  a.dir_in = static_cast<const int32_t*>(dir_in);
  a.carry_in = static_cast<const uint8_t*>(carry_in);
  a.step_in = static_cast<const int32_t*>(step_in);
  a.actions = static_cast<const int32_t*>(actions);
  a.reset_grid = static_cast<const int32_t*>(reset_grid);
  a.reset_scal = static_cast<const int32_t*>(reset_scal);
  a.obs = static_cast<int32_t*>(obs);
  a.reward = static_cast<float*>(reward);
  a.term = static_cast<uint8_t*>(term);
  a.trunc = static_cast<uint8_t*>(trunc);
  a.grid_out = static_cast<uint8_t*>(grid_out);
  a.pos_out = static_cast<int32_t*>(pos_out);
  a.dir_out = static_cast<int32_t*>(dir_out);
  a.carry_out = static_cast<uint8_t*>(carry_out);
  a.step_out = static_cast<int32_t*>(step_out);
  a.term_out = static_cast<uint8_t*>(term_out);
  a.trunc_out = static_cast<uint8_t*>(trunc_out);
  a.B = B; a.T = T; a.W = W; a.H = H; a.max_steps = max_steps;
  a.see_through = see_through; a.native_layout = native_layout;
  return a.reset_grid != nullptr
             ? dispatch<true>(a, view_size, stream)
             : dispatch<false>(a, view_size, stream);
}

const char* fused_step_error_string(int code) {
  return code == -1 ? "unsupported view size"
                    : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
