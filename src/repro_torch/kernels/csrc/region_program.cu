// One launch for an elementwise region of a query, for Hopper (sm_90a),
// bound through a plain C interface (ctypes; see ../build.py).  It replaces
// no TPU kernel: XLA fuses the reference's elementwise ops into one loop
// by itself, where PyTorch runs each torch call of a region (the filters'
// arithmetic, every validity AND, every shifted read's mask) as a pass of
// its own over device memory.  repro_torch/core/region.py lowers each
// region into a straight-line program (region_program.Program); this
// kernel interprets it, compiled once ahead of time, so no query compiles
// code at run time.
//
// The program is the launch's __grid_constant__ parameter: at most
// RP_MAX_LOADS loads, then at most RP_MAX_INS instructions.  A load reads
// one slot of the region (one read of a node's value leaf or validity at
// a tick offset); the wrapper folds the slot's stages into five numbers,
// so output tick j reads tick min(max(j + S, L), U) (as the eager path's
// slice or clamped gather reads it) and lies in range where lo <= j < hi:
// index arithmetic, not a mask read.  Rows are the flattened key and unit
// axes, each input with its own row stride, so the runner's strided
// unit-window views need no copy.
//
// Bound by bytes: each slot's value and validity are read once per tick
// (the shifted reads of one row share cache lines), the computed values
// and the validity written once.  A block runs one tile of RP_TILE ticks
// of a row (grid: tiles x rows); a thread owns RP_GROUPS groups of
// RP_ITEMS consecutive ticks, RP_THREADS * RP_ITEMS apart, so each warp
// access is 512 contiguous bytes.  A load reads a group's four ticks as the
// aligned 16-byte chunks that hold them (4-byte words for bytes) and a
// funnel shift, whatever the slot's offset and the row's alignment; only
// at a row's ends does a thread read tick by tick.  The register file is
// the block's shared memory, a thread's group of a register one 16-byte
// word, indexed by the instruction.  The instructions are the same for
// every thread, so the opcode switch never diverges, and it is taken once
// an instruction for all of a thread's ticks.  On the card (PERF.md, PR 33)
// small blocks with few registers ran these regions fastest: the loads of
// one instruction are all in flight before the thread waits for them.
//
// An instruction's second operand may be an immediate (b < 0: imm, in its
// dtype).  Bits: each instruction rounds as the torch call it was
// recorded from does on the card: __fadd_rn, __fsub_rn, __fmul_rn and
// __fdiv_rn in the recorded order (no FMA contraction); a division by a
// constant is the product with its f32 reciprocal (the wrapper passes the
// reciprocal), as PyTorch's CUDA division by a CPU scalar is; min and max
// return a NaN operand as torch.minimum/maximum and clamp do; f32 -> int32
// truncates and saturates (cvt.rzi), as static_cast does on the card;
// int32 arithmetic wraps.  Every exported function launches on the given
// stream, allocates nothing and returns cudaGetLastError().
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_guard.cuh"

namespace {

constexpr int RP_THREADS = 64;
constexpr int RP_ITEMS = 4;   // consecutive ticks of a group, one uint4
constexpr int RP_GROUPS = 2;  // groups a thread owns, RP_THREADS * 4 apart
constexpr int RP_TILE = RP_THREADS * RP_ITEMS * RP_GROUPS;  // ticks a tile
constexpr int RP_MAX_INS = 64;
constexpr int RP_MAX_LOADS = 32;  // a slot's validity and its leaves
constexpr int RP_MAX_OUTS = 4;
constexpr int RP_MAX_REGS = 12;
constexpr int RP_MAX_GRID_Y = 65535;
// the shared memory up to which a program's loads go through it: the
// lighter kernel, where it leaves enough blocks an SM (PERF.md, PR 33)
constexpr int RP_STAGED_BYTES = 24 * 1024;
static_assert(RP_MAX_REGS * RP_TILE * 4 <= 48 * 1024, "the file fits");

enum Dt { F32 = 0, I32 = 1, BOOL = 2 };
// the order of region_program.OPS
enum Op {
  LOAD, LOADV, CONST, CAST, ADD, SUB, MUL, DIV, DIVC, RECIP, NEG, ABS, MIN,
  MAX, EQ, NE, LT, LE, GT, GE, AND, OR, XOR, NOT, WHERE
};

// A load: the register it writes, and where its slot reads: element j of
// row r at row0 + r * stride, tick min(max(j + S, L), U), kept where
// lo <= j < hi (a validity's range test; everything for a value).
struct Load {
  const uint8_t* row0;
  long long stride;  // bytes
  int S, L, U, lo, hi;
  int dst, bytes, pad;  // bytes: 1-byte elements (bools), else 4
};
struct Ins {
  uint8_t op, dt, pad0, pad1;
  int16_t dst, a, b, c;
  uint32_t imm;
};
struct Out {
  void* ptr;
  long long stride;
  int reg, dt;
};
struct Prog {
  long long rows, cols, tiles;  // rows, output ticks a row, tiles a row
  uint8_t* vout;
  long long vstride;
  int n_loads, n_ops, n_outs, ok, n_regs, pad;
  Load loads[RP_MAX_LOADS];
  Ins ops[RP_MAX_INS];  // what comes after the loads
  Out outs[RP_MAX_OUTS];
};

__device__ __forceinline__ float f(uint32_t x) { return __uint_as_float(x); }
__device__ __forceinline__ uint32_t u(float x) { return __float_as_uint(x); }

__device__ __forceinline__ uint32_t cast(uint32_t x, int from, int to) {
  if (from == to) return x;
  if (to == BOOL) return from == F32 ? (f(x) != 0.0f) : (x != 0u);
  if (to == F32)
    return u(from == I32 ? __int2float_rn((int)x) : (x ? 1.0f : 0.0f));
  return from == F32 ? (uint32_t)__float2int_rz(f(x)) : x;  // to I32
}

// A group of a thread's RP_ITEMS consecutive ticks of one register: the
// register file is the block's dynamic shared memory, n_regs rows of
// RP_TILE words; a thread reads and writes only its own words (no
// barrier), a group as one 16-byte access, at an index the instruction
// gives at run time.
union Q {
  uint4 v;
  uint32_t w[RP_ITEMS];
};
static_assert(RP_ITEMS == 4, "a thread's ticks are one uint4");

#define RP_EACH(stmt) \
  _Pragma("unroll") for (int e = 0; e < RP_ITEMS; ++e) { stmt; }

// Words lo[r..3] then hi[0..r-1]: four consecutive elements that start r
// into an aligned 16-byte chunk (r is the warp's).
__device__ __forceinline__ uint4 funnel(uint4 lo, uint4 hi, int r) {
  switch (r) {
    case 0: return lo;
    case 1: return make_uint4(lo.y, lo.z, lo.w, hi.x);
    case 2: return make_uint4(lo.z, lo.w, hi.x, hi.y);
    default: return make_uint4(lo.w, hi.x, hi.y, hi.z);
  }
}

// Two ways to read a load's four consecutive elements x0 .. x0 + 3 of a
// row, each clamped into [L, U].  Where the four lie inside [L, U] (all
// but a row's last few), both read the aligned chunks that hold them (16
// bytes, or a 4-byte word for bytes: chunks of the row's own allocation;
// the second only where the four straddle two) and shift them into place;
// elsewhere they read the elements one by one.  Where the four fall in a
// chunk (r) is the warp's, and a warp's threads are inside but at a row's
// end: the branches diverge in one warp a row at most.
//
// In registers: `issue` loads into a Read, `take` shifts; a thread issues
// the loads of all its groups before it waits for any.
struct Read {
  uint4 lo, hi;
};

template <typename T>
__device__ __forceinline__ Read issue(const T* q, int a, int r, bool inside,
                                      int x0, int L, int U) {
  Read d;
  if (inside) {
    const int c = (x0 + a) >> 2;  // the chunk, from the aligned start
    if (sizeof(T) == 4) {
      const uint4* base = reinterpret_cast<const uint4*>(
                              reinterpret_cast<const uint32_t*>(q) - a) + c;
      d.lo = __ldg(base);
      if (r) d.hi = __ldg(base + 1);
    } else {
      const uint32_t* base = reinterpret_cast<const uint32_t*>(
                                 reinterpret_cast<const uint8_t*>(q) - a) + c;
      d.lo.x = __ldg(base);
      if (r) d.hi.x = __ldg(base + 1);
    }
  } else {
    d.lo.x = __ldg(q + min(max(x0, L), U));
    d.lo.y = __ldg(q + min(max(x0 + 1, L), U));
    d.lo.z = __ldg(q + min(max(x0 + 2, L), U));
    d.lo.w = __ldg(q + min(max(x0 + 3, L), U));
  }
  return d;
}

template <typename T>
__device__ __forceinline__ Q take(const Read& d, int r, bool inside) {
  Q q;
  if (!inside) {
    q.v = d.lo;
  } else if (sizeof(T) == 4) {
    q.v = funnel(d.lo, d.hi, r);
  } else {
    const uint32_t w = r ? __funnelshift_r(d.lo.x, d.hi.x, 8 * r) : d.lo.x;
    RP_EACH(q.w[e] = (w >> (8 * e)) & 0xffu)
  }
  return q;
}

// Through shared memory: `stage` copies the chunks, with cp.async, into
// the thread's own slot (at a row's ends it reads the elements and writes
// them there), `take_staged` shifts them once the copies are in; every
// load of the program is in flight before the thread waits for any, in no
// register, but each takes shared memory.
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}

// the bytes a thread's group of one load takes in shared memory
__host__ __device__ constexpr int slot_bytes(bool bytes) {
  return bytes ? 8 : 32;
}

template <typename T>
__device__ __forceinline__ void stage(uint8_t* mine, const T* q, int a,
                                      int r, bool inside, int x0, int L,
                                      int U) {
  if (inside) {
    const int c = (x0 + a) >> 2;  // the chunk, from the aligned start
    const int cb = sizeof(T) == 4 ? 16 : 4;
    const uint8_t* base =
        reinterpret_cast<const uint8_t*>(q) - a * (int)sizeof(T) +
        (long long)c * cb;
    copy_async(mine, base, cb);
    if (r) copy_async(mine + cb, base + cb, cb);
  } else {
    T v[RP_ITEMS];
    RP_EACH(v[e] = __ldg(q + min(max(x0 + e, L), U)))
    RP_EACH(reinterpret_cast<T*>(mine)[e] = v[e])
  }
}

template <typename T>
__device__ __forceinline__ Q take_staged(const uint8_t* mine, int r,
                                         bool inside) {
  Q q;
  if (sizeof(T) == 4) {
    const uint4 lo = *reinterpret_cast<const uint4*>(mine);
    q.v = inside && r ? funnel(lo, *reinterpret_cast<const uint4*>(mine + 16),
                               r)
                      : lo;
  } else {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(mine);
    const uint32_t x = inside && r ? __funnelshift_r(w[0], w[1], 8 * r)
                                   : w[0];
    RP_EACH(q.w[e] = (x >> (8 * e)) & 0xffu)
  }
  return q;
}

// The opcode switch's key: op and dtype, and for a cast its source dtype,
// one flat range, so the compiler can jump straight to the case.
__host__ __device__ constexpr int key(int op, int dt, int from = 0) {
  return op == CAST ? (WHERE + 1) * 3 + from * 3 + dt : op * 3 + dt;
}

// One case of the opcode switch: for each of the thread's groups, the
// operands read from the file (b the immediate where the instruction has
// one), `expr` of a and b tick by tick, the result written back.
#define RP_CASE3(KEY, expr, third)                                      \
  case KEY:                                                             \
    _Pragma("unroll") for (int h = 0; h < RP_GROUPS; ++h) {             \
      Q A, B, C, D;                                                     \
      A.v = reg(ra, h);                                                 \
      B.v = rb < 0 ? k4 : reg(rb, h);                                   \
      if (third) C.v = reg(in.c, h);                                    \
      RP_EACH(const uint32_t a = A.w[e]; const uint32_t b = B.w[e];     \
              D.w[e] = (expr))                                          \
      reg(in.dst, h) = D.v;                                             \
    }                                                                   \
    break;
#define RP_CASE(KEY, expr) RP_CASE3(KEY, expr, false)
#define RP_COMPARE(DT, x, y)                                            \
  RP_CASE(key(EQ, DT), x == y) RP_CASE(key(NE, DT), x != y)             \
  RP_CASE(key(LT, DT), x < y) RP_CASE(key(LE, DT), x <= y)              \
  RP_CASE(key(GT, DT), x > y) RP_CASE(key(GE, DT), x >= y)
#define RP_LOGIC(DT)                                                    \
  RP_CASE(key(AND, DT), a & b) RP_CASE(key(OR, DT), a | b)              \
  RP_CASE(key(XOR, DT), a ^ b)
#define RP_CASTS(FROM)                                                  \
  RP_CASE(key(CAST, F32, FROM), cast(a, FROM, F32))                     \
  RP_CASE(key(CAST, I32, FROM), cast(a, FROM, I32))                     \
  RP_CASE(key(CAST, BOOL, FROM), cast(a, FROM, BOOL))

// STAGED: the loads go through shared memory (a program whose file and
// slots fit RP_STAGED_BYTES), else through registers.
template <bool STAGED>
__global__ void __launch_bounds__(RP_THREADS)
    region_program_kernel(const __grid_constant__ Prog p) {
  extern __shared__ uint4 file[];
  const int cols = (int)p.cols, n_loads = p.n_loads, n_ops = p.n_ops;
  const int n_outs = p.n_outs;
  // the thread's group h of register k: one 16-byte word, the warp's words
  // side by side (no bank conflict)
  const auto reg = [&](int k, int h) -> uint4& {
    return file[(k * RP_GROUPS + h) * RP_THREADS + threadIdx.x];
  };
  // past the file, each load's slots, one a thread's group
  uint8_t* stage_at =
      reinterpret_cast<uint8_t*>(file + p.n_regs * RP_GROUPS * RP_THREADS);
  // the first tick of the block's tile, and of the thread's group h:
  // t + h * RP_THREADS * 4
  const int t0 = blockIdx.x * RP_TILE;
  const int t = t0 + RP_ITEMS * threadIdx.x;
  for (long long row = blockIdx.y; row < p.rows; row += gridDim.y) {
    if (STAGED) {
    {
      uint8_t* st = stage_at;
      for (int i = 0; i < n_loads; ++i) {
        const Load d = p.loads[i];
        const uint8_t* q = d.row0 + row * d.stride;
        const int a =
            (int)(reinterpret_cast<uintptr_t>(q) >> (d.bytes ? 0 : 2)) & 3;
        const int r = (t + d.S + a) & 3;
        const int size = slot_bytes(d.bytes);
#pragma unroll
        for (int h = 0; h < RP_GROUPS; ++h) {
          const int x = t + h * RP_THREADS * RP_ITEMS + d.S;
          uint8_t* mine = st + (h * RP_THREADS + threadIdx.x) * size;
          const bool inside = x >= d.L && x + 3 <= d.U;
          if (d.bytes)
            stage(mine, q, a, r, inside, x, d.L, d.U);
          else
            stage(mine, reinterpret_cast<const uint32_t*>(q), a, r, inside,
                  x, d.L, d.U);
        }
        st += RP_GROUPS * RP_THREADS * size;
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    {
      const uint8_t* st = stage_at;
      for (int i = 0; i < n_loads; ++i) {
        const Load d = p.loads[i];
        const uint8_t* q = d.row0 + row * d.stride;
        const int a =
            (int)(reinterpret_cast<uintptr_t>(q) >> (d.bytes ? 0 : 2)) & 3;
        const int r = (t + d.S + a) & 3;
        const int size = slot_bytes(d.bytes);
        // a validity's range test, where the tile is not all in range
        const bool test = t0 < d.lo || t0 + RP_TILE > d.hi;
#pragma unroll
        for (int h = 0; h < RP_GROUPS; ++h) {
          const int th = t + h * RP_THREADS * RP_ITEMS;
          const int x = th + d.S;
          const uint8_t* mine = st + (h * RP_THREADS + threadIdx.x) * size;
          const bool inside = x >= d.L && x + 3 <= d.U;
          // a bool is stored as 0 or 1: its byte is the value
          Q v = d.bytes ? take_staged<uint8_t>(mine, r, inside)
                        : take_staged<uint32_t>(mine, r, inside);
          if (test)
            RP_EACH(if (th + e < d.lo || th + e >= d.hi) v.w[e] = 0u)
          reg(d.dst, h) = v.v;
        }
        st += RP_GROUPS * RP_THREADS * size;
      }
    }
    } else {
    for (int i = 0; i < n_loads; ++i) {
      Read got[RP_GROUPS];
      bool inside[RP_GROUPS];
      const Load d = p.loads[i];
      const uint8_t* q = d.row0 + row * d.stride;
      const int a = (int)(reinterpret_cast<uintptr_t>(q) >> (d.bytes ? 0 : 2))
                    & 3;
      const int r = (t + d.S + a) & 3;
#pragma unroll
      for (int h = 0; h < RP_GROUPS; ++h) {
        const int x = t + h * RP_THREADS * RP_ITEMS + d.S;
        inside[h] = x >= d.L && x + 3 <= d.U;
        got[h] = d.bytes ? issue(q, a, r, inside[h], x, d.L, d.U)
                         : issue(reinterpret_cast<const uint32_t*>(q), a, r,
                                 inside[h], x, d.L, d.U);
      }
      const Load e2 = p.loads[i];  // read again: the registers stay few
      const bool test = t0 < e2.lo || t0 + RP_TILE > e2.hi;
#pragma unroll
      for (int h = 0; h < RP_GROUPS; ++h) {
        const int th = t + h * RP_THREADS * RP_ITEMS;
        // a bool is stored as 0 or 1: its byte is the value
        Q v = e2.bytes ? take<uint8_t>(got[h], r, inside[h])
                       : take<uint32_t>(got[h], r, inside[h]);
        if (test)
          RP_EACH(if (th + e < e2.lo || th + e >= e2.hi) v.w[e] = 0u)
        reg(e2.dst, h) = v.v;
      }
    }
    }
    for (int i = 0; i < n_ops; ++i) {
      const Ins in = p.ops[i];
      const uint4 k4 = make_uint4(in.imm, in.imm, in.imm, in.imm);
      const int ra = in.a < 0 ? 0 : in.a, rb = in.b;
      switch (key(in.op, in.dt, in.op == CAST ? (int)in.imm : 0)) {
        RP_CASE(key(CONST, F32), in.imm) RP_CASE(key(CONST, I32), in.imm)
        RP_CASE(key(CONST, BOOL), in.imm)
        RP_CASTS(F32) RP_CASTS(I32) RP_CASTS(BOOL)
        RP_CASE(key(DIVC, F32), u(__fmul_rn(f(a), f(in.imm))))
        RP_CASE(key(RECIP, F32), u(__fdiv_rn(1.0f, f(a))))
        RP_CASE(key(NEG, F32), a ^ 0x80000000u)
        RP_CASE(key(NEG, I32), 0u - a)
        RP_CASE(key(ABS, F32), a & 0x7fffffffu)
        RP_CASE(key(ABS, I32), (int)a < 0 ? 0u - a : a)
        RP_CASE(key(NOT, I32), ~a) RP_CASE(key(NOT, BOOL), a ^ 1u)
        RP_CASE(key(ADD, F32), u(__fadd_rn(f(a), f(b))))
        RP_CASE(key(SUB, F32), u(__fsub_rn(f(a), f(b))))
        RP_CASE(key(MUL, F32), u(__fmul_rn(f(a), f(b))))
        RP_CASE(key(DIV, F32), u(__fdiv_rn(f(a), f(b))))
        RP_CASE(key(MIN, F32),
                f(a) != f(a) ? a : f(b) != f(b) ? b : u(fminf(f(a), f(b))))
        RP_CASE(key(MAX, F32),
                f(a) != f(a) ? a : f(b) != f(b) ? b : u(fmaxf(f(a), f(b))))
        RP_COMPARE(F32, f(a), f(b))
        RP_CASE(key(ADD, I32), a + b) RP_CASE(key(SUB, I32), a - b)
        RP_CASE(key(MUL, I32), a * b)
        RP_CASE(key(MIN, I32), (uint32_t)min((int)a, (int)b))
        RP_CASE(key(MAX, I32), (uint32_t)max((int)a, (int)b))
        RP_COMPARE(I32, (int)a, (int)b) RP_LOGIC(I32)
        RP_CASE(key(MIN, BOOL), min(a, b)) RP_CASE(key(MAX, BOOL), max(a, b))
        RP_COMPARE(BOOL, a, b) RP_LOGIC(BOOL)
        RP_CASE3(key(WHERE, F32), a ? b : C.w[e], true)
        RP_CASE3(key(WHERE, I32), a ? b : C.w[e], true)
        RP_CASE3(key(WHERE, BOOL), a ? b : C.w[e], true)
        default:;
      }
    }
    // the validity, then each value, four ticks a group
#pragma unroll
    for (int h = 0; h < RP_GROUPS; ++h) {
      const int th = t + h * RP_THREADS * RP_ITEMS;
      const bool whole = th + 3 < cols;
      Q v;
      v.v = reg(p.ok, h);
      uint8_t* q = p.vout + row * p.vstride + th;
      if (whole && (reinterpret_cast<uintptr_t>(q) & 3) == 0)
        *reinterpret_cast<uint32_t*>(q) =
            v.w[0] | v.w[1] << 8 | v.w[2] << 16 | v.w[3] << 24;
      else
        RP_EACH(if (th + e < cols) q[e] = (uint8_t)v.w[e])
    }
    for (int o = 0; o < n_outs; ++o) {
      const Out out = p.outs[o];
#pragma unroll
      for (int h = 0; h < RP_GROUPS; ++h) {
        const int th = t + h * RP_THREADS * RP_ITEMS;
        const bool whole = th + 3 < cols;
        Q v;
        v.v = reg(out.reg, h);
        if (out.dt == BOOL) {
          uint8_t* q = static_cast<uint8_t*>(out.ptr) + row * out.stride + th;
          if (whole && (reinterpret_cast<uintptr_t>(q) & 3) == 0)
            *reinterpret_cast<uint32_t*>(q) =
                v.w[0] | v.w[1] << 8 | v.w[2] << 16 | v.w[3] << 24;
          else
            RP_EACH(if (th + e < cols) q[e] = (uint8_t)v.w[e])
        } else {
          uint32_t* q = static_cast<uint32_t*>(out.ptr) + row * out.stride + th;
          if (whole && (reinterpret_cast<uintptr_t>(q) & 15) == 0)
            *reinterpret_cast<uint4*>(q) = v.v;
          else
            RP_EACH(if (th + e < cols) q[e] = v.w[e])
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// The constants the wrapper is built on: the tile, the limits packed six
// bits each (instructions, loads, outputs, registers) and the size of the
// launch parameter.
int rp_tile() { return RP_TILE; }
long long rp_limits() {
  return (((long long)RP_MAX_INS * 64 + RP_MAX_LOADS) * 64 + RP_MAX_OUTS) *
             64 + RP_MAX_REGS;
}
int rp_param_bytes() { return (int)sizeof(Prog); }

// prog: the launch parameter (region_program._Prog), every pointer,
// stride and read filled in.  One block a tile of a row (rows past the
// grid's 65535 taken in turn by the blocks of a column).
int rp_region_program(const void* prog, int device, void* stream) {
  const Prog& p = *static_cast<const Prog*>(prog);
  if (p.rows < 1 || p.cols < 1 || p.tiles < 1 || p.tiles >= (1LL << 31) ||
      p.n_loads < 1 ||
      p.n_loads > RP_MAX_LOADS || p.n_ops < 0 || p.n_ops > RP_MAX_INS ||
      p.n_outs < 0 || p.n_outs > RP_MAX_OUTS || p.n_regs < 1 ||
      p.n_regs > RP_MAX_REGS || p.ok < 0 || p.ok >= p.n_regs)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < p.n_loads; ++i)
    if (p.loads[i].dst < 0 || p.loads[i].dst >= p.n_regs)
      return (int)cudaErrorInvalidValue;
  const auto in_file = [&](int k) { return k >= 0 && k < p.n_regs; };
  for (int i = 0; i < p.n_ops; ++i) {
    const Ins& in = p.ops[i];
    if (!in_file(in.dst) || in.op > WHERE || in.op == LOAD ||
        in.op == LOADV || (in.op != CONST && !in_file(in.a)) ||
        in.b >= p.n_regs ||
        (in.op == WHERE && (!in_file(in.b) || !in_file(in.c))))
      return (int)cudaErrorInvalidValue;
  }
  for (int o = 0; o < p.n_outs; ++o)
    if (!in_file(p.outs[o].reg)) return (int)cudaErrorInvalidValue;
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return (int)guard.err;
  // shared memory: the file, n_regs rows of RP_TILE words, and for a
  // staged program the loads' slots
  size_t smem = (size_t)p.n_regs * RP_TILE * sizeof(uint32_t);
  for (int i = 0; i < p.n_loads; ++i)
    smem += (size_t)RP_GROUPS * RP_THREADS * slot_bytes(p.loads[i].bytes);
  const bool staged = smem <= RP_STAGED_BYTES;
  if (!staged) smem = (size_t)p.n_regs * RP_TILE * sizeof(uint32_t);
  const dim3 grid((unsigned)p.tiles,
                  (unsigned)(p.rows < RP_MAX_GRID_Y ? p.rows : RP_MAX_GRID_Y));
  if (staged)
    region_program_kernel<true><<<grid, RP_THREADS, smem,
                                  static_cast<cudaStream_t>(stream)>>>(p);
  else
    region_program_kernel<false><<<grid, RP_THREADS, smem,
                                   static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
