// Persistent, warp-specialised tile product on Hopper's tensor cores (TMA,
// mbarrier ring, wgmma), for the retrieval kernels: each finished [128
// query rows x 256 corpus rows] accumulator tile is handed to an epilogue
// functor, and the [M, N] scores never reach device memory. Six epilogues
// run on it: row_max (row_max.cu), count_above (count_above.cu),
// pool_writer (pool_writer.cu), fused_topk (fused_topk.cu), and scores and
// scores_above (scores.cu), each over a bf16 corpus (.bf16) and an int8 one
// (.int8, the corpus policy I8Corpus below). The product loop is one
// instruction sequence for all the epilogues of a corpus policy (the same
// wgmma shape, k-slice depth, pass / kt / kk order and zero-filled k
// padding), so they see bit-identical f32 accumulators for a (q, r) pair at
// the same padded D, and pool_writer and fused_topk take each segment's
// winners with the one segment_top2 below: the streaming verify compares
// fused_topk's candidates, and the pooled prune the pool, with count_above's
// counts bit for bit.
//
// Arithmetic (Bf16Corpus). bf16 q [M, D] and refs [N, D] (both K-major, as
// they lie in memory) go to shared memory unwidened; wgmma.mma_async
// m64n256k16 multiplies them with f32 accumulation. The tensor cores sum
// each k16 step in their own order, so a score is not the sequential fmaf
// chain of reduce_gemm.cuh: exact on integer inputs (every partial sum <
// 2^24), within a few f32 rounding steps elsewhere.
//
// Arithmetic (I8Corpus: SQ8, f32 queries against int8 codes with an f32
// scale per corpus row; a score is (q . codes[j]) * scale[j]). The caller
// splits each f32 query row into three bf16 rows, hi + mid + lo == q
// exactly (ops/kernels.py split_bf16x3), stacked [3, M, D]. Each code is
// exact in bf16 and each product code x term (7 x 8 significant bits) is
// exact in f32, so three wgmma passes over the same widened code tile into
// one f32 accumulator give q . codes to within the tensor cores' summation
// error. Each k-slice runs the passes lo, then mid, then hi (the small
// terms first) over its one widened corpus slice. With integer
// (or any bf16-exact) queries mid and lo are zero, the first two passes
// add exact zeros, and the scores are the bf16 product's on the widened
// codes bit for bit. finish() multiplies each finished accumulator column
// by its corpus row's scale, one f32 multiply as JAX's `s * sc`, before
// the epilogue sees the tile (columns at or past n_valid take 0).
//
// Operands. TMA needs a 16-byte-aligned base and a row stride that is a
// multiple of 16 bytes, so bf16 rows hold a multiple of 8 values and codes
// rows a multiple of 16 (ops/kernels.py pad_columns zero-pads the path's
// D = 511; the zero columns add 0 to every product). TMA zero-fills
// whatever lies past the tensor: query rows >= M, corpus rows >= n_valid,
// k >= D.
//
// Block. Three warpgroups: warpgroups 0 and 1 consume (64 query rows each,
// all 256 corpus rows; 128 f32 accumulators a thread, setmaxnreg 232), and
// warpgroup 2 produces (setmaxnreg 40). Its first thread keeps TMA loads
// of 64-deep k-slices (128 bytes of a bf16 row: one 128-byte swizzle row)
// in flight into a ring of kStages stages of 48 KB (16 KB of queries, 32
// KB of bf16 corpus), each guarded by a "full" mbarrier and an "empty" one
// (both consumers done); the wgmma shared-memory descriptors use the same
// 128-byte swizzle. Bf16Corpus: TMA lands both operands and completes
// "full". I8Corpus: the same bytes hold a query ring of kStages + 2 16 KB
// stages (one query plane's slice each) and a corpus ring of kStages - 1
// 32 KB stages. TMA lands a corpus slice's int8 codes (a 64-byte box a
// row, 16 KB) in the upper half of a corpus stage ("landedB"); warps 1-3
// of the producer warpgroup (96 threads) widen them in place into the
// swizzled bf16 tile wgmma reads (widen_codes), fence them to the async
// proxy and arrive on "fullB"; the consumers run the three passes over it,
// each with its own query stage, and release it ("emptyB") after the
// third. So each code is widened once, every epilogue's shared memory fits
// beside the ring as in bf16, and the corpus ring's depth hides the
// widening behind three passes of product. (The first design widened each
// slice once a pass, in one ring of 48 KB stages: 19.7 ms at the SSCD row
// max against 10.3 for this one, tools/bench_reduce.py --int8, PERF.md
// section 6.)
//
// Work. Query tiles (128 rows) form groups of E::kGroup tiles (kGroup
// unless the epilogue needs fewer); a work item is (group, corpus tile,
// query tile in the group), numbered group major, then corpus tile, then
// query tile (ops/kernels.py wgmma_item), and the
// grid is one wave of persistent blocks, block b walking the contiguous
// items [b*W/G, (b+1)*W/G). Consecutive items share a corpus tile, so each
// corpus tile comes from HBM about once per group while the queries (a few
// MB) are re-read from L2: the row-tile-major order of reduce_gemm.cuh
// would stream the whole corpus once per query tile. The epilogue keeps
// the group's per-row state in shared memory and is told when the block's
// range leaves a group (or ends), so its atomics are (blocks x rows).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "block_list.cuh"
#include "segment_top2.cuh"

namespace vsc {
namespace wg {

constexpr int BM = 128;            // query rows per work item
constexpr int BN = 256;            // corpus rows per work item
constexpr int BK = 64;             // depth of a ring stage: 128 bytes of bf16
constexpr int kStages = 4;         // ring depth (an epilogue's E::kStages)
constexpr int kGroup = 8;          // query tiles per group (E::kGroup)
constexpr int kConsumers = 2;      // consumer warpgroups, 64 query rows each
constexpr int THREADS = 128 * (kConsumers + 1);
constexpr int kAcc = BN / 2;       // f32 accumulators a consumer thread holds
constexpr int A_BYTES = BM * BK * 2;
constexpr int B_BYTES = BN * BK * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int kAlign = 1024;       // a 128-byte swizzle pattern repeats per 1 KB
constexpr int I8_ALIGN = 16;       // int8 codes per row: a multiple (16-byte rows)
// I8Corpus: the codes of a stage's corpus slice (BN rows of BK bytes) land
// at this offset of its corpus buffer, the upper half, and the producer's
// last three warps widen them.
constexpr int CODE_BYTES = BN * BK;
constexpr int CODE_OFFSET = B_BYTES - CODE_BYTES;
constexpr int kWideners = 96;

// The launch's work.
struct Plan {
  int n_valid, kt_n;       // kt_n: k-slices (D / BK rounded up)
  int q_tiles, c_tiles;
  int items;               // sum over groups of c_tiles x the group's tiles
};

struct Item {
  int group, q_tile, c_tile, slot, tiles;  // slot: q_tile within the group
};

template <int G>
__device__ __forceinline__ Item item_at(const Plan& p, int i) {
  Item it;
  const int per_group = p.c_tiles * G;
  it.group = i / per_group;
  const int local = i - it.group * per_group;
  it.tiles = min(G, p.q_tiles - it.group * G);
  it.c_tile = local / it.tiles;
  it.slot = local - it.c_tile * it.tiles;
  it.q_tile = it.group * G + it.slot;
  return it;
}

// A consumer thread's place in the accumulator tile (wgmma's m64nN f32
// layout): rows row0 and row0 + 8 of the 128, columns 8j + col0 + {0, 1};
// acc[4j + e] is (row0, 8j + col0 + e), acc[4j + 2 + e] is (row0 + 8, ...).
// The quad (lanes with one lane / 4) holds all 256 columns of both rows;
// `owner` (quad == 0) keeps the quad's per-row results.
struct Lane {
  int row0, col0, quad;
  bool owner;
};

// Epilogue E over a list of corpus blocks (block_list.cuh): the launch's
// corpus tile c is list.corpus_tile(c), whose rows TMA loads and which
// every hook (and I8Corpus::finish) sees as Item::c_tile; groups, slots and
// the plan's items stay the launch's (the listed blocks' tiles). A kernel
// of its own (the products below instantiated for it), so the full-corpus
// kernels keep their code.
template <class E>
struct Blocks {
  static constexpr int kStages = E::kStages, kGroup = E::kGroup;
  using Smem = typename E::Smem;
  E ep;
  BlockList list;

  __device__ __forceinline__ void begin(Smem& s, const Lane& l) const { ep.begin(s, l); }

  template <bool kMasked>
  __device__ __forceinline__ void item(Smem& s, const Lane& l, float (&acc)[kAcc],
                                       const Item& it, int valid_cols) const {
    ep.template item<kMasked>(s, l, acc, it, valid_cols);
  }

  __device__ __forceinline__ void flush(Smem& s, const Lane& l, const Item& it) const {
    ep.flush(s, l, it);
  }
};

template <class E>
struct is_blocks : std::false_type {};
template <class E>
struct is_blocks<Blocks<E>> : std::true_type {};

// Work item i of the launch, its corpus tile in the corpus's numbering.
template <class E>
__device__ __forceinline__ Item item_of(const Plan& p, const E& ep, int i) {
  Item it = item_at<E::kGroup>(p, i);
  if constexpr (is_blocks<E>::value) it.c_tile = ep.list.corpus_tile(it.c_tile);
  return it;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Spin until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// A [box rows x 64] tile at (k0, row0) of a 2-D tensor map into shared
// memory, completing its bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int k0,
                                         int row0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(row0), "r"(smem_u32(bar))
      : "memory");
}

// The same from plane z of a 3-D tensor map (the split query terms).
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int k0,
                                            int row0, int z, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(row0), "r"(z),
      "r"(smem_u32(bar))
      : "memory");
}

// Generic-proxy writes to shared memory made visible to the async proxy
// (wgmma's operand reads) before the barrier that publishes them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier 1 of the producer's widening warps.
__device__ __forceinline__ void wideners_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWideners) : "memory");
}

// wgmma descriptor of a K-major tile with the 128-byte swizzle: rows of
// 128 bytes, 8-row core groups 1024 bytes apart (SBO), layout type 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t smem_addr) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators
// across the asynchronous product (its registers change under the asm).
__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A[64 x 16] . B[256 x 16]^T; scale_d == 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[kAcc], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// The best 2 of each pool segment of a finished tile for the thread's two
// rows: b[h][g] for row row0 + 8h and segment g, the tile's columns
// [128g, 128g + 128) (j < 16 and j >= 16 in the lane layout), with global
// column ids. Each thread takes the best 2 of its 32 values per row and
// segment with selects, and two xor shuffles merge the quad, so all four
// lanes of the quad end with all four results. Every lane of the warp must
// call it. Ties go to the lower column; with kMasked, columns at or past
// valid_cols read -inf and never enter (a slot no valid column reached
// stays (-inf, INT_MAX)).
template <bool kMasked>
__device__ __forceinline__ void segment_top2(const float (&acc)[kAcc],
                                             const Lane& l, int c_tile,
                                             int valid_cols, Top2 (&b)[2][2]) {
  const int cbase = c_tile * BN;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int g = 0; g < 2; ++g)
      b[h][g] = {-CUDART_INF_F, INT_MAX, -CUDART_INF_F, INT_MAX};
#pragma unroll
  for (int j = 0; j < kAcc / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      // A thread's columns come in ascending order, so a strict '>' keeps
      // the lower column on equal values (the pool order).
      const int col = 8 * j + l.col0 + e;
      const bool valid = !kMasked || col < valid_cols;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        Top2& t = b[h][j / 16];
        const float v = valid ? acc[4 * j + 2 * h + e] : -CUDART_INF_F;
        const bool first = v > t.v1, second = v > t.v2;
        t.v2 = first ? t.v1 : second ? v : t.v2;
        t.i2 = first ? t.i1 : second ? cbase + col : t.i2;
        t.v1 = first ? v : t.v1;
        t.i1 = first ? cbase + col : t.i1;
      }
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int g = 0; g < 2; ++g) b[h][g] = merge(b[h][g], shfl_xor_top2(b[h][g], off));
}

// ---- the corpus operand ------------------------------------------------------
//
// A corpus policy C names its kernel (kWiden: wgmma_i8_kernel, else
// wgmma_kernel) and the mbarriers of its ring (barriers(kStages)), for the
// host side (kernel_of, smem_bytes, configure, resident_blocks).

// bf16 rows: TMA lands them as wgmma reads them; the scores go out as summed.
// The ring: kStages stages of one query slice and one corpus slice, a
// "full" and an "empty" barrier each.
struct Bf16Corpus {
  static constexpr bool kWiden = false;
  static constexpr int barriers(int stages) { return 2 * stages; }
};

// int8 codes with an f32 scale per corpus row (SQ8), against the split query
// terms [3, M, D] (hi, mid, lo): for each k-slice the three passes lo, mid,
// hi over one widened corpus slice; then each column times its row's scale.
// The ring holds bf16's bytes (kStages x 48 KB) split into a query ring of
// a_stages 16 KB stages ("fullA" by TMA, "emptyA") and a corpus ring of
// b_stages 32 KB stages ("landedB" by TMA, "fullB" by the widening warps,
// "emptyB" once all three passes are done): kStages + 2 and kStages - 1.
// finish() takes the thread's scores of a finished item, once, before the
// epilogue (columns at or past valid_cols are not the corpus's).
struct I8Corpus {
  static constexpr int kPasses = 3;
  static constexpr bool kWiden = true;
  __host__ __device__ static constexpr int a_stages(int stages) { return stages + 2; }
  __host__ __device__ static constexpr int b_stages(int stages) { return stages - 1; }
  __host__ __device__ static constexpr int barriers(int stages) {
    return 2 * a_stages(stages) + 3 * b_stages(stages);
  }
  const float* scale;  // one per corpus row

  __device__ __forceinline__ void finish(float (&acc)[kAcc], const Lane& l,
                                         const Item& it, int valid_cols) const {
    const float* sc = scale + (size_t)it.c_tile * BN;
#pragma unroll
    for (int j = 0; j < kAcc / 4; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + l.col0 + e;
        const float f = col < valid_cols ? sc[col] : 0.f;
        acc[4 * j + e] *= f;
        acc[4 * j + 2 + e] *= f;
      }
    }
  }
};

static_assert(I8Corpus::a_stages(3) * A_BYTES + I8Corpus::b_stages(3) * B_BYTES ==
                      3 * STAGE_BYTES &&
                  I8Corpus::a_stages(4) * A_BYTES + I8Corpus::b_stages(4) * B_BYTES ==
                      4 * STAGE_BYTES,
              "the int8 rings take the bf16 ring's bytes");

// Four int8 codes (the lower column in the low byte) as two bf16x2 words,
// exactly: each code c, as the unsigned byte c + 128 under the exponent of
// 2^23, is the f32 2^23 + c + 128; less 2^23 + 128 it is c, and an integer
// of at most 8 bits keeps its f32 low 16 bits zero, so its bf16 is the f32's
// upper half. No conversion instruction: 4 byte permutes, 4 adds, 2 permutes.
__device__ __forceinline__ uint2 widen4(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int b = 0; b < 4; ++b)
    f[b] = __fadd_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 | b)),
                     -8388736.f);
  return make_uint2(__byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
                    __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
}

// Piece p (codes 16p..16p+15) of corpus row r as two 16-byte bf16 chunks,
// 2p and 2p + 1 of the row, at their 128-byte-swizzled places (chunk c of
// row r at c ^ (r % 8): the layout TMA gives a bf16 tile and sw128_desc
// reads).
__device__ __forceinline__ void store_piece(unsigned char* tile, int r, int p,
                                            int4 v) {
  const uint2 a = widen4((uint32_t)v.x), b = widen4((uint32_t)v.y);
  const uint2 c = widen4((uint32_t)v.z), d = widen4((uint32_t)v.w);
  unsigned char* row = tile + 128 * r;
  *reinterpret_cast<uint4*>(row + 16 * ((2 * p) ^ (r & 7))) = make_uint4(a.x, a.y, b.x, b.y);
  *reinterpret_cast<uint4*>(row + 16 * ((2 * p + 1) ^ (r & 7))) =
      make_uint4(c.x, c.y, d.x, d.y);
}

__device__ __forceinline__ int4 load_piece(const unsigned char* tile, int r, int p) {
  return *reinterpret_cast<const int4*>(tile + CODE_OFFSET + 64 * r + 16 * p);
}

// The widening of one corpus stage in place, by the kWideners threads (t:
// 0..95).
// The codes of row r lie at CODE_OFFSET + 64 r (16 KB on), its bf16 row at
// 128 r, so: rows 0-127 write the lower 16 KB, which holds no code; rows
// 128-191 write the codes of rows 0-127, read by then (barrier); rows
// 192-255 write the codes of rows 128-255, so they read their own first and
// write after a second barrier, which also waits for every read of rows
// 128-191. A warp reads 8 rows x 4 pieces, 512 contiguous bytes, and its
// stores of one chunk parity cover the 8 chunk positions of a row pair.
__device__ __forceinline__ void widen_codes(unsigned char* tile, int t) {
  for (int q = t; q < 128 * 4; q += kWideners)
    store_piece(tile, q >> 2, q & 3, load_piece(tile, q >> 2, q & 3));
  wideners_sync();
  for (int q = 128 * 4 + t; q < 192 * 4; q += kWideners)
    store_piece(tile, q >> 2, q & 3, load_piece(tile, q >> 2, q & 3));
  constexpr int kLast = (64 * 4 + kWideners - 1) / kWideners;  // pieces a thread
  int4 v[kLast];
#pragma unroll
  for (int k = 0; k < kLast; ++k) {
    const int q = 192 * 4 + t + k * kWideners;
    if (q < BN * 4) v[k] = load_piece(tile, q >> 2, q & 3);
  }
  wideners_sync();
#pragma unroll
  for (int k = 0; k < kLast; ++k) {
    const int q = 192 * 4 + t + k * kWideners;
    if (q < BN * 4) store_piece(tile, q >> 2, q & 3, v[k]);
  }
}

// One k-slice of the product: acc (+)= A[64 x 64] . B[256 x 64]^T from the
// swizzled tiles at a and b, four k16 steps; `first` overwrites acc.
__device__ __forceinline__ void mma_slice(float (&acc)[kAcc], uint32_t a, uint32_t b,
                                          bool first) {
  wgmma_fence();
  fence_acc(acc);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)  // 16 values = 32 bytes a step
    wgmma_m64n256k16(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk),
                     !first || kk > 0);
  wgmma_commit();
  wgmma_wait_all();
  fence_acc(acc);
}

__device__ __forceinline__ void advance(int& stage, unsigned& phase, int stages) {
  if (++stage == stages) {
    stage = 0;
    phase ^= 1;
  }
}

// The product and its epilogue E. E names its ring depth and group size
// (static constexpr int kStages, kGroup: the product loop does not depend
// on them), and every consumer thread calls each hook:
//   struct Smem;                      dynamic shared memory past the ring
//                                     (and E's extra bytes past it)
//   void begin(Smem&, const Lane&) const;
//   template <bool kMasked>           kMasked: the item's corpus tile
//   void item(Smem&, const Lane&,     straddles n_valid; columns at or past
//             const float (&acc)[kAcc], valid_cols are not the corpus's
//             const Item&, int valid_cols) const;
//   void flush(Smem&, const Lane&, const Item&) const;
//                                     the block leaves the item's group
//                                     (or ends)
// The hooks run in each consumer warpgroup on its own 64 rows: they need
// no barrier as long as each row's state is touched by one thread.
template <class E>
__global__ void __launch_bounds__(THREADS, 1)
    wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                 __grid_constant__ const CUtensorMap tr, Plan p, E ep) {
  constexpr int kStages = E::kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* ring = smem_raw + ((kAlign - (raw & (kAlign - 1))) & (kAlign - 1));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * STAGE_BYTES);
  uint64_t* empty = full + kStages;
  typename E::Smem& es = *reinterpret_cast<typename E::Smem*>(empty + kStages);

  const int begin = (int)((long long)p.items * blockIdx.x / gridDim.x);
  const int end = (int)((long long)p.items * (blockIdx.x + 1) / gridDim.x);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warpgroup = threadIdx.x / 128;
  if (warpgroup == kConsumers) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 128 * kConsumers) {
      int stage = 0;
      unsigned phase = 0;
      for (int i = begin; i < end; ++i) {
        const Item it = item_of(p, ep, i);
        for (int kt = 0; kt < p.kt_n; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], STAGE_BYTES);
          unsigned char* dst = ring + stage * STAGE_BYTES;
          tma_load(dst, &tq, kt * BK, it.q_tile * BM, &full[stage]);
          tma_load(dst + A_BYTES, &tr, kt * BK, it.c_tile * BN, &full[stage]);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers: wgmma over each stage, then the epilogue ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31;
    Lane ln;
    ln.row0 = 64 * warpgroup + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    ln.quad = lane & 3;
    ln.col0 = 2 * ln.quad;
    ln.owner = ln.quad == 0;
    ep.begin(es, ln);
    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    const uint32_t a_off = warpgroup * 64 * BK * 2;  // this warpgroup's 64 rows
    int stage = 0;
    unsigned phase = 0;
    for (int i = begin; i < end; ++i) {
      const Item it = item_of(p, ep, i);
      for (int kt = 0; kt < p.kt_n; ++kt) {
        mbar_wait(&full[stage], phase);
        const uint32_t a = smem_u32(ring + stage * STAGE_BYTES) + a_off;
        const uint32_t b = smem_u32(ring + stage * STAGE_BYTES + A_BYTES);
        wgmma_fence();
        fence_acc(acc);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)  // 16 values = 32 bytes a step
          wgmma_m64n256k16(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk),
                           kt > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(acc);
        mbar_arrive(&empty[stage]);
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      const int valid_cols = p.n_valid - it.c_tile * BN;
      if (valid_cols >= BN)
        ep.template item<false>(es, ln, acc, it, valid_cols);
      else
        ep.template item<true>(es, ln, acc, it, valid_cols);
      if (i + 1 == end || item_at<E::kGroup>(p, i + 1).group != it.group)
        ep.flush(es, ln, it);
      __syncwarp();  // converged again before the next wgmma (.aligned)
    }
  }
}

// The same product over int8 codes (I8Corpus): a query ring of kA stages
// (fullA by TMA, emptyA) and a corpus ring of kB stages (landedB by TMA,
// fullB by the widening warps, emptyB after the third pass), three passes
// a k-slice, the scale before the epilogue, the hooks as above. A kernel of
// its own, so that the bf16 kernel keeps its instruction stream (shared
// device helpers inlined into both moved the bf16 kernels' registers).
template <class E>
__global__ void __launch_bounds__(THREADS, 1)
    wgmma_i8_kernel(__grid_constant__ const CUtensorMap tq,
                    __grid_constant__ const CUtensorMap tr, Plan p, E ep,
                    I8Corpus corpus) {
  constexpr int kStages = E::kStages;
  constexpr int kA = I8Corpus::a_stages(kStages), kB = I8Corpus::b_stages(kStages);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* ring = smem_raw + ((kAlign - (raw & (kAlign - 1))) & (kAlign - 1));
  unsigned char* ring_b = ring + kA * A_BYTES;  // the corpus ring
  uint64_t* full_a = reinterpret_cast<uint64_t*>(ring + kStages * STAGE_BYTES);
  uint64_t* empty_a = full_a + kA;
  uint64_t* landed_b = empty_a + kA;
  uint64_t* full_b = landed_b + kB;
  uint64_t* empty_b = full_b + kB;
  typename E::Smem& es = *reinterpret_cast<typename E::Smem*>(empty_b + kB);

  const int begin = (int)((long long)p.items * blockIdx.x / gridDim.x);
  const int end = (int)((long long)p.items * (blockIdx.x + 1) / gridDim.x);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kA; ++s) {
      mbar_init(&full_a[s], 1);
      mbar_init(&empty_a[s], 128 * kConsumers);
    }
    for (int s = 0; s < kB; ++s) {
      mbar_init(&landed_b[s], 1);
      mbar_init(&full_b[s], kWideners);
      mbar_init(&empty_b[s], 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warpgroup = threadIdx.x / 128;
  if (warpgroup == kConsumers) {
    // ---- producer: one thread keeps both rings full, the last three warps
    // widen each landed corpus slice ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int pt = threadIdx.x - 128 * kConsumers;
    int sa = 0, sb = 0;
    unsigned pa = 0, pb = 0;
    if (pt == 0) {
      for (int i = begin; i < end; ++i) {
        const Item it = item_of(p, ep, i);
        for (int kt = 0; kt < p.kt_n; ++kt) {
          mbar_wait(&empty_b[sb], pb ^ 1);
          mbar_expect_tx(&landed_b[sb], CODE_BYTES);
          tma_load(ring_b + sb * B_BYTES + CODE_OFFSET, &tr, kt * BK, it.c_tile * BN,
                   &landed_b[sb]);
          advance(sb, pb, kB);
          for (int pass = 0; pass < I8Corpus::kPasses; ++pass) {
            mbar_wait(&empty_a[sa], pa ^ 1);
            mbar_expect_tx(&full_a[sa], A_BYTES);
            tma_load_3d(ring + sa * A_BYTES, &tq, kt * BK, it.q_tile * BM,
                        I8Corpus::kPasses - 1 - pass, &full_a[sa]);
            advance(sa, pa, kA);
          }
        }
      }
    } else if (pt >= 128 - kWideners) {
      for (int i = begin; i < end; ++i) {
        for (int kt = 0; kt < p.kt_n; ++kt) {
          mbar_wait(&landed_b[sb], pb);
          widen_codes(ring_b + sb * B_BYTES, pt - (128 - kWideners));
          fence_proxy_async();
          mbar_arrive(&full_b[sb]);
          advance(sb, pb, kB);
        }
      }
    }
  } else {
    // ---- consumers: three passes over each widened slice, then the
    // scales and the epilogue ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x & 31;
    Lane ln;
    ln.row0 = 64 * warpgroup + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    ln.quad = lane & 3;
    ln.col0 = 2 * ln.quad;
    ln.owner = ln.quad == 0;
    ep.begin(es, ln);
    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
    const uint32_t a_off = warpgroup * 64 * BK * 2;  // this warpgroup's 64 rows
    int sa = 0, sb = 0;
    unsigned pa = 0, pb = 0;
    for (int i = begin; i < end; ++i) {
      const Item it = item_of(p, ep, i);
      for (int kt = 0; kt < p.kt_n; ++kt) {
        mbar_wait(&full_b[sb], pb);
        const uint32_t b = smem_u32(ring_b + sb * B_BYTES);
        for (int pass = 0; pass < I8Corpus::kPasses; ++pass) {
          mbar_wait(&full_a[sa], pa);
          mma_slice(acc, smem_u32(ring + sa * A_BYTES) + a_off, b, kt == 0 && pass == 0);
          mbar_arrive(&empty_a[sa]);
          advance(sa, pa, kA);
        }
        mbar_arrive(&empty_b[sb]);
        advance(sb, pb, kB);
      }
      const int valid_cols = p.n_valid - it.c_tile * BN;
      corpus.finish(acc, ln, it, valid_cols);
      if (valid_cols >= BN)
        ep.template item<false>(es, ln, acc, it, valid_cols);
      else
        ep.template item<true>(es, ln, acc, it, valid_cols);
      if (i + 1 == end || item_at<E::kGroup>(p, i + 1).group != it.group)
        ep.flush(es, ln, it);
      __syncwarp();  // converged again before the next wgmma (.aligned)
    }
  }
}

// The kernel of E over corpus C.
template <class E, class C>
inline auto kernel_of() {
  if constexpr (C::kWiden)
    return wgmma_i8_kernel<E>;
  else
    return wgmma_kernel<E>;
}

// Dynamic shared memory of E's kernel over corpus C: alignment slack, ring,
// barriers, the epilogue's state and `extra` bytes of it past its Smem.
template <class E, class C = Bf16Corpus>
constexpr int smem_bytes(int extra = 0) {
  return kAlign + E::kStages * STAGE_BYTES +
         C::barriers(E::kStages) * (int)sizeof(uint64_t) +
         (int)sizeof(typename E::Smem) + extra;
}

template <class E, class C = Bf16Corpus>
cudaError_t configure(int extra) {
  return cudaFuncSetAttribute(kernel_of<E, C>(),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<E, C>(extra));
}

// Blocks of E's kernel over corpus C an SM holds at once (0: it cannot
// launch).
template <class E, class C = Bf16Corpus>
int resident_blocks(int device, int* blocks_per_sm, int extra = 0) {
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = configure<E, C>(extra);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel_of<E, C>(), THREADS, smem_bytes<E, C>(extra));
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, fetched through the runtime (no
// link against libcuda).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Tensor map of `planes` row-major [rows, d] bf16 planes one after another
// (a 2-D map for one plane, else 3-D), read in [box_rows x 64] boxes of one
// plane with the 128-byte swizzle; out-of-bounds elements read as zero.
inline bool encode(CUtensorMap* map, const __nv_bfloat16* base, int rows, int d,
                   int box_rows, int planes = 1) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)d * sizeof(__nv_bfloat16),
                                 (cuuint64_t)rows * d * sizeof(__nv_bfloat16)};
  const cuuint32_t box[3] = {(cuuint32_t)BK, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, planes > 1 ? 3 : 2,
            const_cast<__nv_bfloat16*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Tensor map of row-major [rows, d] int8 codes (d a multiple of I8_ALIGN),
// read in [BN x 64]-byte boxes, unswizzled (the widening's layout);
// out-of-bounds codes read as zero.
inline bool encode_codes(CUtensorMap* map, const int8_t* base, int rows, int d) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)BN};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<int8_t*>(base), dims,
            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The plan of an [m, n_valid] call at depth d (ops/kernels.py wgmma_tiles).
inline Plan plan(int m, int n_valid, int d) {
  Plan p;
  p.n_valid = n_valid;
  p.kt_n = (d + BK - 1) / BK;
  p.q_tiles = (m + BM - 1) / BM;
  p.c_tiles = (n_valid + BN - 1) / BN;
  const long long items = (long long)p.q_tiles * p.c_tiles;
  p.items = items > INT_MAX ? -1 : (int)items;
  return p;
}

// The plan of the same call over the listed blocks: their tiles.
inline Plan plan(int m, int n_valid, int d, const BlockList& list) {
  Plan p = plan(m, n_valid, d);
  p.c_tiles = list.launch_tiles();
  const long long items = (long long)p.q_tiles * p.c_tiles;
  p.items = items > INT_MAX ? -1 : (int)items;
  return p;
}

// The block list of `ids` (n blocks of col_block rows, col_block a multiple
// of BN); false if col_block is not.
inline bool block_list(BlockList* list, const int* ids, int n, int col_block) {
  if (n < 0 || col_block <= 0 || col_block % BN != 0) return false;
  *list = BlockList{ids, n, col_block / BN};
  return true;
}

// Launch `grid` blocks over the items of plan p: q [m, d] and refs
// [>= n_valid, d] bf16, d % 8 == 0, both bases 16-byte aligned; the
// epilogue takes `extra` bytes of shared memory past its Smem.
template <class E>
cudaError_t launch_plan(const __nv_bfloat16* q, const __nv_bfloat16* refs, int m,
                        int d, const Plan& p, int grid, const E& ep, cudaStream_t s,
                        int extra) {
  if (d <= 0 || d % 8 != 0 || p.items < 0 || grid <= 0 || grid > p.items ||
      ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(refs)) & 15))
    return cudaErrorInvalidValue;
  CUtensorMap tq, tr;
  if (!encode(&tq, q, m, d, BM) || !encode(&tr, refs, p.n_valid, d, BN))
    return cudaErrorInvalidValue;
  cudaError_t err = configure<E>(extra);
  if (err != cudaSuccess) return err;
  wgmma_kernel<E><<<grid, THREADS, smem_bytes<E>(extra), s>>>(tq, tr, p, ep);
  return cudaGetLastError();
}

// Launch `grid` blocks over the items of an [m, n_valid] call (launch_plan's
// operands). Nothing when there are no items.
template <class E>
cudaError_t launch(const __nv_bfloat16* q, const __nv_bfloat16* refs, int m,
                   int d, int n_valid, int grid, const E& ep, cudaStream_t s,
                   int extra = 0) {
  if (m <= 0 || n_valid <= 0) return cudaSuccess;
  return launch_plan(q, refs, m, d, plan(m, n_valid, d), grid, ep, s, extra);
}

// The same over the listed blocks (E's kernel over the list, Blocks<E>);
// nothing for an empty list.
template <class E>
cudaError_t launch_blocks(const __nv_bfloat16* q, const __nv_bfloat16* refs, int m,
                          int d, int n_valid, const BlockList& list, int grid,
                          const E& ep, cudaStream_t s, int extra = 0) {
  if (m <= 0 || n_valid <= 0 || list.n == 0) return cudaSuccess;
  return launch_plan(q, refs, m, d, plan(m, n_valid, d, list), grid,
                     Blocks<E>{ep, list}, s, extra);
}

// The same over int8 codes (I8Corpus): terms [3, m, d] bf16 (the split
// queries hi, mid, lo), codes [>= n_valid, d] int8 with scale [>= n_valid]
// f32, d a multiple of I8_ALIGN, both bases 16-byte aligned.
template <class E>
cudaError_t launch_plan_int8(const __nv_bfloat16* terms, const int8_t* codes,
                             const float* scale, int m, int d, const Plan& p,
                             int grid, const E& ep, cudaStream_t s, int extra) {
  if (d <= 0 || d % I8_ALIGN != 0 || p.items < 0 || grid <= 0 || grid > p.items ||
      ((reinterpret_cast<uintptr_t>(terms) | reinterpret_cast<uintptr_t>(codes)) & 15))
    return cudaErrorInvalidValue;
  CUtensorMap tq, tr;
  if (!encode(&tq, terms, m, d, BM, I8Corpus::kPasses) ||
      !encode_codes(&tr, codes, p.n_valid, d))
    return cudaErrorInvalidValue;
  cudaError_t err = configure<E, I8Corpus>(extra);
  if (err != cudaSuccess) return err;
  wgmma_i8_kernel<E><<<grid, THREADS, smem_bytes<E, I8Corpus>(extra), s>>>(
      tq, tr, p, ep, I8Corpus{scale});
  return cudaGetLastError();
}

template <class E>
cudaError_t launch_int8(const __nv_bfloat16* terms, const int8_t* codes,
                        const float* scale, int m, int d, int n_valid, int grid,
                        const E& ep, cudaStream_t s, int extra = 0) {
  if (m <= 0 || n_valid <= 0) return cudaSuccess;
  return launch_plan_int8(terms, codes, scale, m, d, plan(m, n_valid, d), grid, ep, s,
                          extra);
}

template <class E>
cudaError_t launch_blocks_int8(const __nv_bfloat16* terms, const int8_t* codes,
                               const float* scale, int m, int d, int n_valid,
                               const BlockList& list, int grid, const E& ep,
                               cudaStream_t s, int extra = 0) {
  if (m <= 0 || n_valid <= 0 || list.n == 0) return cudaSuccess;
  return launch_plan_int8(terms, codes, scale, m, d, plan(m, n_valid, d, list), grid,
                          Blocks<E>{ep, list}, s, extra);
}

}  // namespace wg
}  // namespace vsc
