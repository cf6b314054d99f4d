// The post-step of a BabyAI level on Hopper: the instruction verifier, the
// success reward and the dynamic step budget, one launch a step.
//
// Replaces no TPU kernel: the JAX package's verifier
// (minigrid_tpu/envs/babyai/core/instrs.py::verify) is jnp under jit, which
// XLA fuses on the TPU. In eager PyTorch the same code
// (minigrid_tpu_torch/envs/babyai/core/instrs.py::verify and the reward
// arithmetic of envs/babyai/core/post_step.py::babyai_post_step_reference,
// its plain version) is ~366 launches of a few microseconds each per step, so this
// kernel computes the whole of it: the tracking of the descriptors' objects
// across the transition, both phases of the four leaf slots under the root
// combinator, the status, the reward 1 - 0.9 * step_count / max_steps on
// success and 0 on failure, terminated, and truncation at the budget.
//
// The verifier's "any bit set" tests reduce to single words. The packed
// masks are (B, 8, H) int32 rows, bit x of row y marking cell (x, y), and
// each test ANDs a mask with the one-hot of a cell in front of the agent or
// with its 4-neighbourhood: one bit of row fy, or bits of rows fy - 1, fy,
// fy + 1. The tracking update changes at most the word of row fy (of the
// previous state's front cell) in each slot. So one thread an env computes
// everything from ~50 bytes of scalars and flags and 40 words of its masks,
// and the masks' copy to the output is a plain copy with one word an env
// and slot edited.
//
// Bound: latency, not bytes. At B=4096 and H=8 (PutNextLocal) a launch reads
// and writes the two mask arrays, 4 * 2 * 8 * 8 bytes an env each way, and
// ~60 bytes of flags and scalars: ~4.8 MB, 1.4 us at 3.35 TB/s. An env's
// thread waits on two dependent rounds of loads: its scalars, then the
// cells and mask words in front of the two agents, each round issued at
// once (addresses clamped into the grid, so no branch stands before a
// load; the words off the grid are masked after). A block holds
// kEnvsPerBlock envs: their threads, the first warp, verify their envs and
// leave each env's edit (row, bit, slots to set, whether the action was a
// drop) in shared memory, while all kThreads threads have already loaded
// the block's envs' mask words, one 32-bit word a thread in turn, so that a
// warp's loads and stores are 128 contiguous bytes; after the block's
// barrier they store them, edited. At B=4096 that is 128 blocks, about one
// an SM.
//
// Float rule: the reward is rounded after each operation (__fmul_rn,
// __fdiv_rn, __fsub_rn; the build passes -fmad=false), as PyTorch computes
// 1.0 - 0.9 * t / m in float32, so it is bit-identical to the plain
// version.
//
// A library of its own with a plain C interface, built and loaded with
// ctypes through ops/native.py (envs/babyai/core/post_step.py::LIBRARY).

#include <cstdint>
#include <cstddef>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kEmpty = 1, kDoor = 4, kBox = 7;  // object types
constexpr int kOpen = 0;                        // door state
constexpr int kPickup = 3, kDrop = 4, kToggle = 5, kDone = 6;  // actions
constexpr int kOpenLeaf = 0, kGoto = 1, kPickupLeaf = 2, kPutNext = 3;
constexpr int kRootAction = 0, kRootAnd = 1, kRootBefore = 2, kRootAfter = 3;
constexpr int kContinue = 0, kSuccess = 1, kFailure = 2;
constexpr int kSlots = 8, kLeaves = 4;
constexpr int kEnvsPerBlock = 32;
constexpr int kThreads = 256;
constexpr int kMaxPackedWidth = 24;  // instrs.py MAX_PACKED_WIDTH
constexpr int kBadLaunch = -1;

// The pointer table's order: the inputs of
// envs/babyai/core/post_step.py::_inputs, then the outputs.
struct VerifyArgs {
  // the previous state
  const int32_t* prev_pos;    // (B, 2)
  const int32_t* prev_dir;    // (B,)
  const uint8_t* prev_carry;  // (B, 5)
  const uint8_t* prev_grid;   // (B, W, H, 5)
  // the state the step entry produced
  const int32_t* pos;
  const int32_t* dir;
  const uint8_t* carry;
  const uint8_t* grid;
  const int32_t* step_count;  // (B,)
  const int32_t* action;      // (B,)
  // the InstrState (bools as bytes)
  const int32_t* root_kind;   // (B,)
  const uint8_t* a_is_and;    // (B,)
  const uint8_t* b_is_and;    // (B,)
  const int32_t* kinds;       // (B, 4)
  const uint8_t* strict;      // (B, 4)
  const int32_t* mask_objs;   // (B, 8, H)
  const int32_t* mask_poss;   // (B, 8, H)
  const uint8_t* carried;     // (B, 8)
  const uint8_t* pre_empty;   // (B, 4)
  const uint8_t* pre_move_carried;  // (B, 4)
  const uint8_t* last_match;  // (B, 4)
  const uint8_t* leaf_done;   // (B, 4)
  const uint8_t* a_done;      // (B,)
  const uint8_t* b_done;      // (B,)
  const int32_t* max_steps;   // (B,) the dynamic budget
  const float* reward;        // (B,) the step entry's
  const uint8_t* terminated;  // (B,) the step entry's
  // outputs
  int32_t* masks;        // mask_objs (B, 8, H), then mask_poss (B, 8, H)
  int32_t* status;       // (B,)
  float* reward_out;     // (B,)
  uint8_t* carried_out;  // (B, 8)
  uint8_t* memory;       // pre_empty, pre_move_carried, last_match,
                         // leaf_done: (B, 4) each
  uint8_t* ends;         // a_done, b_done, terminated, truncated: (B,) each
  int B, W, H, done_actions;
};
constexpr int kPointers = 33;

// A load through the read-only cache: no input is written during a launch.
template <typename T>
__device__ __forceinline__ T ld(const T* p) {
  return __ldg(p);
}

// The cell in front of an agent as the verifier packs it: row `row` (-1
// when off the grid's rows), bit `bit` (0 when off its columns), and the
// cell's type and state (0 off the grid). The cell is loaded from a
// clamped address, so that no branch stands before the load.
struct Front {
  int row, bit, type, state;
};

__device__ Front front_of(const int32_t* pos, const int32_t* dir,
                          const uint8_t* grid, long long b, int W, int H) {
  const int d = ld(dir + b);
  const int x = ld(pos + 2 * b) + (d == 0) - (d == 2);
  const int y = ld(pos + 2 * b + 1) + (d == 1) - (d == 3);
  const bool in_x = x >= 0 && x < W, in_y = y >= 0 && y < H;
  const uint8_t* cell =
      grid + ((b * W + min(max(x, 0), W - 1)) * H + min(max(y, 0), H - 1)) *
                 5;
  const int type = ld(cell), state = ld(cell + 2);
  return Front{in_y ? y : -1, in_x ? 1 << x : 0, in_x && in_y ? type : 0,
               in_x && in_y ? state : 0};
}

// One env's tracking edit, left for the block's copy of the masks.
struct Edit {
  int row, bit, set, drop;
};

// The word of mask_objs after the tracking update.
__device__ __forceinline__ int edited(int w, int slot, int row,
                                      const Edit& e) {
  if (row != e.row) return w;
  return (e.set >> slot & 1) ? (w | e.bit) : (w & ~e.bit);
}

// Word `row` of slot `slot` of an env's (8, H) rows, loaded from a row
// clamped into the grid (the caller masks a row off it).
__device__ __forceinline__ int row_word(const int32_t* rows, int slot,
                                        int row, int H) {
  return ld(rows + slot * H + min(max(row, 0), H - 1));
}

__device__ __forceinline__ void load_flags(bool* v, const uint8_t* p,
                                           int n) {
  for (int i = 0; i < n; ++i) v[i] = ld(p + i) != 0;
}

__device__ __forceinline__ void store_flags(uint8_t* p, const bool* v,
                                            int n) {
  for (int i = 0; i < n; ++i) p[i] = v[i];
}

// Verifies env b and returns its edit of the masks. Every input is loaded
// in two rounds, each issued at once: what depends on no position, then
// the cells and mask words in front of the two agents.
__device__ Edit verify_env(const VerifyArgs& a, long long b) {
  const int W = a.W, H = a.H;
  const int32_t* objs = a.mask_objs + b * kSlots * H;  // the env's rows
  const int32_t* poss = a.mask_poss + b * kSlots * H;
  const int act = ld(a.action + b);
  const bool was_empty = ld(a.prev_carry + 5 * b) == kEmpty;
  const bool now_empty = ld(a.carry + 5 * b) == kEmpty;
  const bool now_carrying = !now_empty;
  const int rk = ld(a.root_kind + b);
  const bool a_and = ld(a.a_is_and + b) != 0, b_and = ld(a.b_is_and + b) != 0;
  const bool a_done = ld(a.a_done + b) != 0, b_done = ld(a.b_done + b) != 0;
  const int t = ld(a.step_count + b), m = ld(a.max_steps + b);
  const float reward_in = ld(a.reward + b);
  const bool term_in = ld(a.terminated + b) != 0;
  int kinds[kLeaves];
  bool strict[kLeaves], carried[kSlots];
  bool pe[kLeaves], pmc[kLeaves], lm[kLeaves], ldone[kLeaves];
  for (int i = 0; i < kLeaves; ++i) kinds[i] = ld(a.kinds + kLeaves * b + i);
  load_flags(strict, a.strict + kLeaves * b, kLeaves);
  load_flags(carried, a.carried + kSlots * b, kSlots);
  load_flags(pe, a.pre_empty + kLeaves * b, kLeaves);
  load_flags(pmc, a.pre_move_carried + kLeaves * b, kLeaves);
  load_flags(lm, a.last_match + kLeaves * b, kLeaves);
  load_flags(ldone, a.leaf_done + kLeaves * b, kLeaves);

  // the previous front (update_tracking) and the new one (leaf_commons)
  const Front pf = front_of(a.prev_pos, a.prev_dir, a.prev_grid, b, W, H);
  const Front nf = front_of(a.pos, a.dir, a.grid, b, W, H);
  const int y = nf.row, bit = nf.bit;
  int at[kSlots];             // objs at the previous front's row
  int mo[kLeaves], mp[kLeaves];  // move slots at the new front's row
  int fo[kLeaves][3], fp[kLeaves][3];  // fixed slots at its rows y-1..y+1
  for (int s = 0; s < kSlots; ++s) at[s] = row_word(objs, s, pf.row, H);
  for (int i = 0; i < kLeaves; ++i) {
    mo[i] = row_word(objs, 2 * i, y, H);
    mp[i] = row_word(poss, 2 * i, y, H);
    for (int r = 0; r < 3; ++r) {
      fo[i][r] = row_word(objs, 2 * i + 1, y - 1 + r, H);
      fp[i][r] = row_word(poss, 2 * i + 1, y - 1 + r, H);
    }
  }

  // update_tracking: identity and position tracking across the transition
  const bool picked = act == kPickup && was_empty && !now_empty;
  const bool dropped = act == kDrop && !was_empty && now_empty;
  const bool box_gone = act == kToggle && pf.type == kBox;
  int set = 0;
  for (int s = 0; s < kSlots; ++s) {
    const bool at_front = pf.row >= 0 && (at[s] & pf.bit) != 0;
    const bool take = picked && at_front, lose_box = box_gone && at_front;
    const bool gain = dropped && carried[s];
    if ((at_front && !take && !lose_box) || gain) set |= 1 << s;
    carried[s] = take || (!gain && carried[s]);
  }
  const Edit e{pf.row, pf.bit, set, act == kDrop};

  // the leaf slots' tests against the new front, on the tracked masks
  // (mask_poss takes mask_objs on a drop)
  const int beside = (bit << 1) | (bit >> 1);  // the row's neighbours
  bool mo_hit[kLeaves], mp_hit[kLeaves], put_hit[kLeaves];
  for (int i = 0; i < kLeaves; ++i) {
    const int mv = 2 * i, fixed = 2 * i + 1;
    const int objs_y = edited(mo[i], mv, y, e);
    mo_hit[i] = y >= 0 && (objs_y & bit) != 0;
    mp_hit[i] = y >= 0 && ((e.drop ? objs_y : mp[i]) & bit) != 0;
    int near[3];
    for (int r = 0; r < 3; ++r)
      near[r] = e.drop ? edited(fo[i][r], fixed, y - 1 + r, e) : fp[i][r];
    put_hit[i] = y >= 0 && ((near[1] & beside) |
                            (y > 0 ? near[0] & bit : 0) |
                            (y + 1 < H ? near[2] & bit : 0)) != 0;
  }

  // leaf_verify_all for slot i under `gate`: updates the memory, returns
  // whether the slot fails
  const bool toggle = act == kToggle, pk = act == kPickup;
  const bool door = nf.type == kDoor;
  const bool drop_ok = act == kDrop && !was_empty && now_empty;
  auto leaf = [&](int i, bool gate) {
    const int k = kinds[i];
    const bool cmv = carried[2 * i];
    const bool open_s = toggle && mo_hit[i] && door && nf.state == kOpen;
    const bool open_f = toggle && strict[i] && door && !open_s;
    const bool pick_s = pk && pe[i] && cmv && now_carrying;
    const bool pick_f = pk && strict[i] && now_carrying && !pick_s;
    const bool put_s = drop_ok && pmc[i] && put_hit[i];
    const bool put_f = pk && strict[i] && now_carrying;
    bool succ = k == kOpenLeaf ? open_s
                : k == kGoto ? mp_hit[i]
                : k == kPickupLeaf ? pick_s
                : k == kPutNext ? put_s : false;
    bool fail = k == kOpenLeaf ? open_f
                : k == kPickupLeaf ? pick_f
                : k == kPutNext ? (put_f && !put_s) : false;
    bool runs = gate;
    if (a.done_actions) {
      const bool is_done = act == kDone;
      const bool reported_s = is_done && lm[i], reported_f = is_done && !lm[i];
      if (gate && !is_done) lm[i] = succ;
      succ = reported_s;
      fail = reported_f;
      runs = gate && !is_done;
    }
    succ = succ && gate;
    fail = fail && gate;
    if (runs && (k == kPickupLeaf || k == kPutNext)) {
      pe[i] = !now_carrying;
      pmc[i] = cmv;
    }
    ldone[i] = ldone[i] || succ;
    return fail;
  };
  auto leaves = [&](const bool g[kLeaves]) {
    bool fails = false;
    for (int i = 0; i < kLeaves; ++i) fails |= leaf(i, g[i]);
    return fails;
  };

  // verify: phase 1 runs the part that goes first (A, or B for "after")
  const bool before = rk == kRootBefore, after = rk == kRootAfter;
  const bool* done = ldone;
  const bool g1[kLeaves] = {
      (rk == kRootAction || rk == kRootAnd) ? !done[0]
          : before ? (!a_done && !done[0]) : false,
      rk == kRootAnd ? !done[1]
          : before ? (!a_done && a_and && !done[1]) : false,
      after && !b_done && !done[2],
      after && !b_done && b_and && !done[3]};
  bool fails = leaves(g1);
  bool ad = a_done || (done[0] && (!a_and || done[1]));
  bool bd = b_done || (done[2] && (!b_and || done[3]));
  // phase 2: the other part, gated on phase 1's completion
  const bool g2[kLeaves] = {
      after && bd && !done[0], after && bd && a_and && !done[1],
      before && ad && !done[2], before && ad && b_and && !done[3]};
  fails |= leaves(g2);
  ad = a_done || (done[0] && (!a_and || done[1]));
  bd = b_done || (done[2] && (!b_and || done[3]));
  const bool success = rk == kRootAction ? done[0]
                       : rk == kRootAnd ? (done[0] && done[1])
                       : (before || after) ? (ad && bd) : false;
  // AndInstr swallows child failures outside done-actions mode
  const bool fail_counts = rk != kRootAnd || a.done_actions;
  const int status = success ? kSuccess
                     : (fails && fail_counts) ? kFailure : kContinue;

  // the level's step: reward, terminated, truncated
  const float won = __fsub_rn(
      1.0f, __fdiv_rn(__fmul_rn(0.9f, (float)t), (float)m));
  const long long B = a.B;
  a.status[b] = status;
  a.reward_out[b] = status == kSuccess ? won
                    : status == kFailure ? 0.0f : reward_in;
  store_flags(a.carried_out + kSlots * b, carried, kSlots);
  store_flags(a.memory + kLeaves * b, pe, kLeaves);
  store_flags(a.memory + kLeaves * (B + b), pmc, kLeaves);
  store_flags(a.memory + kLeaves * (2 * B + b), lm, kLeaves);
  store_flags(a.memory + kLeaves * (3 * B + b), ldone, kLeaves);
  a.ends[b] = ad;
  a.ends[B + b] = bd;
  a.ends[2 * B + b] = term_in || status != kContinue;
  a.ends[3 * B + b] = t >= m;
  return e;
}

// Words of each mask array a thread loads before its block's envs are
// verified: all of them while a block's envs have at most 8 rows (64 words
// an env, 2,048 a block); the rest are loaded after.
constexpr int kPrefetch = kEnvsPerBlock * kSlots * 8 / kThreads;

__global__ void __launch_bounds__(kThreads)
    babyai_post_step_kernel(VerifyArgs a) {
  __shared__ Edit edits[kEnvsPerBlock];
  const long long b0 = (long long)blockIdx.x * kEnvsPerBlock;
  const int n = (int)min((long long)kEnvsPerBlock, a.B - b0);
  // the block's envs' mask words, contiguous in both arrays
  const int H = a.H, per_env = kSlots * H, words = n * per_env;
  const long long base = b0 * per_env;
  const long long masks = (long long)a.B * per_env;
  int objs[kPrefetch], poss[kPrefetch];
  for (int j = 0; j < kPrefetch; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < words) {
      objs[j] = ld(a.mask_objs + base + i);
      poss[j] = ld(a.mask_poss + base + i);
    }
  }
  if ((int)threadIdx.x < n)
    edits[threadIdx.x] = verify_env(a, b0 + threadIdx.x);
  __syncthreads();
  auto store = [&](int i, int objs_word, int poss_word) {
    const Edit& e = edits[i / per_env];
    const int w = edited(objs_word, i / H % kSlots, i % H, e);
    a.masks[base + i] = w;
    a.masks[masks + base + i] = e.drop ? w : poss_word;
  };
  for (int j = 0; j < kPrefetch; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if (i < words) store(i, objs[j], poss[j]);
  }
  for (int i = threadIdx.x + kPrefetch * kThreads; i < words; i += kThreads)
    store(i, ld(a.mask_objs + base + i), ld(a.mask_poss + base + i));
}

}  // namespace

extern "C" {

// Launches on `stream` and returns 0, -1 for a shape the kernel does not
// take (B, H >= 1; 1 <= W <= 24, the packed masks' width), or the CUDA
// error of the launch. `pointers` is a host array of kPointers device
// pointers in VerifyArgs' order; done_actions is BABYAI_DONE_ACTIONS'
// mode (0 or 1).
int babyai_post_step_launch(const void* const* pointers, int B, int W, int H,
                            int done_actions, void* stream) {
  if (B < 1 || H < 1 || W < 1 || W > kMaxPackedWidth) return kBadLaunch;
  static_assert(offsetof(VerifyArgs, B) == sizeof(void*) * kPointers,
                "the pointer table and VerifyArgs disagree");
  VerifyArgs a;
  std::memcpy(&a, pointers, sizeof(void*) * kPointers);
  a.B = B; a.W = W; a.H = H; a.done_actions = done_actions;
  const int blocks = (B + kEnvsPerBlock - 1) / kEnvsPerBlock;
  babyai_post_step_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* babyai_post_step_error_string(int code) {
  return code == kBadLaunch
             ? "unsupported shape"
             : cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
