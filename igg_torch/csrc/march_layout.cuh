// What the unstaggered x-marches share (hm3d_march.cuh: the HM3D band and
// chunk kernels; diffusion_march.cuh: the diffusion band kernel): a thread
// block owns a (y, z) tile of one extended block of chunk_walk.cuh's Chunk
// and walks x over a segment of it, every cell computed once at its source
// position and written to each target that takes it.  Here: the rows with
// a target, the wrap targets, the edge rules of the two realizations and
// the cut of x into segments.
//
// The two realizations' edge rules (the policies E of the marches):
//   - BandEdges, the banded realization (band_walk.cuh's header,
//     igg_torch/ops/chunk_engine.py: banded_window_plain): every row x of an
//     extended block is updated, its x neighbours clamped to the block's
//     first and last rows; on open dims the chunk-entry values F replace
//     exactly the freeze rows lo and hi of the edge blocks, resolved in
//     band_halo's order, z, then y, then x (a target on a z freeze row takes
//     F there, on a y or x freeze row F at the source's z, on an x freeze
//     row F at the source cell);
//   - ChunkEdges, the K-step chunk (chunk_walk.cuh's rules,
//     chunk_engine.window_step_plain): the outermost rows of each extended
//     block keep their source values, so no x plane needs a clamp (the
//     march clamps the staged planes all the same, to stay inside the
//     block, and never uses what lies beyond); on open dims every row
//     `<= lo` / `>= hi` of the edge blocks takes F at the target cell.
// In both, rows on a block's y/z outer planes keep their source values and
// a WRAP dim's edge cells take the updated values at the inner cells they
// alias (0 <- s-ol, s-1 <- ol-1; the chunk's overlap is 2, the fused
// step's aliases), and the last launch of a chunk writes only each block's
// central window, straight into the unextended outputs.
//
// A third policy, StepEdges, is the fused step's (step_walk.cuh's modes on
// whole blocks, the targets laid out like the sources, halo cells written
// by the same launch): per dim WRAP (one periodic block, x included: the
// updated cell s-2 is also written to 0, cell 1 also to s-1), RECV (a
// block's halo cells take the received plane's value) or FROZEN (a block's
// outer cells keep their source values); a cell's value is resolved z, then
// y, then x, as step_walk.cuh's resolve_cells resolves it (the march's
// note says how).
#pragma once

#include "async_copy.cuh"
#include "chunk_walk.cuh"

namespace igg {

// The band walk's edge rules (module note).
struct BandEdges {
  static constexpr bool CHUNK = false;
  static constexpr bool STEP = false;
  // The staged plane of source plane p: the block's x ends clamp.
  __device__ __forceinline__ static int plane(int p, int s0) {
    return march_clamp(p, 0, s0 - 1);
  }
  // Whether row r of block bl along d is a freeze row there.
  __device__ __forceinline__ static bool frozen(const Chunk& c, int d, int bl,
                                                int r) {
    return c.frz[d] && ((bl == 0 && r == c.lo[d]) ||
                        (bl == c.geo.n[d] - 1 && r == c.hi[d]));
  }
};

// The chunk walk's edge rules (module note): rows 0 and s0 - 1 are never
// updated, so the clamped planes beyond them are never used.
struct ChunkEdges {
  static constexpr bool CHUNK = true;
  static constexpr bool STEP = false;
  __device__ __forceinline__ static int plane(int p, int s0) {
    return march_clamp(p, 0, s0 - 1);
  }
  __device__ __forceinline__ static bool frozen(const Chunk& c, int d, int bl,
                                                int r) {
    return c.frz[d] && ((bl == 0 && r <= c.lo[d]) ||
                        (bl == c.geo.n[d] - 1 && r >= c.hi[d]));
  }
};

// The fused step's edge rules (module note): no freeze; a block's outer x
// rows are never updated, as the chunk's (CHUNK), so the clamped planes
// beyond them are never used.
struct StepEdges {
  static constexpr bool CHUNK = true;
  static constexpr bool STEP = true;
  __device__ __forceinline__ static int plane(int p, int s0) {
    return march_clamp(p, 0, s0 - 1);
  }
  __device__ __forceinline__ static bool frozen(const Chunk&, int, int, int) {
    return false;
  }
};

// The wrap overlaps of a march's arguments `m` (fields c, ol, first, rows)
// and, per dim, the first source row with a target (a target block's row 0)
// and the source rows with a target (a target block's extent).  Returns
// false where the layout does not suit a march: blocks under 3 cells, or a
// wrap other than on one block of y or z with an overlap in [2, s].
template <class M>
inline bool march_rows(M& m, int ol_y, int ol_z) {
  const Geo& g = m.c.geo;
  m.ol[0] = 0;
  m.ol[1] = ol_y;
  m.ol[2] = ol_z;
  for (int d = 0; d < 3; ++d) {
    if (g.s[d] < 3) return false;
    if (g.mode[d] == WRAP &&
        (d == 0 || g.n[d] != 1 || m.ol[d] < 2 || m.ol[d] > g.s[d]))
      return false;
    m.first[d] = m.c.last ? m.c.off[d] : 0;
    m.rows[d] = m.c.last ? m.c.os[d] : g.s[d];
    if (m.first[d] < 0 || m.first[d] + m.rows[d] > g.s[d]) return false;
  }
  return true;
}

// cfg: chunk_engine.band_cfg (make_chunk's 25 ints, then B lo extra ol_y
// ol_z): the layout of the band walk (band_walk.cuh's make_band), B dividing
// the extended x span.  The marches take B as a gate only.
template <class M>
inline bool march_band_layout(const int* cfg, M& m) {
  if (!make_chunk(cfg, m.c)) return false;
  const int B = cfg[25], lo = cfg[26], extra = cfg[27];
  if (B < 1 || m.c.geo.s[0] % B != 0 || lo < 1 || extra < 1) return false;
  return march_rows(m, cfg[28], cfg[29]);
}

// cfg: chunk_engine.chunk_cfg (make_chunk's 25 ints); a chunk wraps with
// overlap 2, as the fused step does.
template <class M>
inline bool march_chunk_layout(const int* cfg, M& m) {
  return make_chunk(cfg, m.c) && march_rows(m, 2, 2);
}

// cfg: n[3] s[3] mode[3] (make_geo's, the fused step's): whole blocks of at
// least 3 cells, the targets laid out like the sources, wraps (on any dim,
// one block) of overlap 2.  Returns false where the layout does not suit a
// march.
template <class M>
inline bool march_step_layout(const int* cfg, M& m) {
  Chunk& c = m.c;
  c.geo = make_geo(cfg);
  c.last = 0;
  for (int d = 0; d < 3; ++d) {
    const Geo& g = c.geo;
    if (g.s[d] < 3 || (g.mode[d] == WRAP && g.n[d] != 1)) return false;
    c.frz[d] = c.lo[d] = c.hi[d] = c.off[d] = 0;
    c.os[d] = g.s[d];
    c.OG[d] = g.G[d];
    m.ol[d] = 2;
    m.first[d] = 0;
    m.rows[d] = g.s[d];
  }
  return true;
}

// The targets of source row c along a dim (wrap: the aliases; else the row
// itself where a target holds it), as target rows.
__device__ __forceinline__ int march_targets(int c, bool wrap, int toff,
                                             int tos, int s, int ol, int* tg) {
  int n = 0;
  if (!wrap) {
    const int t = c - toff;
    if (t >= 0 && t < tos) tg[n++] = t;
    return n;
  }
  if (c >= 1 && c <= s - 2) tg[n++] = c;
  if (c == s - ol) tg[n++] = 0;
  if (c == ol - 1) tg[n++] = s - 1;
  return n;
}

// The targets of source row c along a dim as bits: bit 0 the row itself
// (wrap: 1 <= c <= s-2; else where a target holds it, [toff, toff + tos)),
// bit 1 row 0 (wrap: c == s-ol), bit 2 row s-1 (wrap: c == ol-1); the
// rows of march_targets, in the source's rows (a wrap's window starts at
// 0).
__device__ __forceinline__ int march_target_bits(int c, bool wrap, int toff,
                                                 int tos, int s, int ol) {
  if (!wrap) return c >= toff && c < toff + tos;
  return (c >= 1 && c <= s - 2) | (c == s - ol) << 1 | (c == ol - 1) << 2;
}

// Offset of cell (i, j, k) of block b on blocks of extents e stacked into
// a tensor of extents G.
__device__ __forceinline__ long long march_at(const int* e, const int* G,
                                              const int* b, int i, int j,
                                              int k) {
  return ((long long)(b[0] * e[0] + i) * G[1] + b[1] * e[1] + j) *
             (long long)G[2] +
         b[2] * e[2] + k;
}

// The launch of a march over (z tiles, y tiles, x segments) of every block,
// tiles of TY x TZ: where the tiles give fewer than `blocks` thread blocks,
// x is cut into segments of at least `min_seg` rows.  Sets m.ty, m.tz,
// m.seg and m.nseg and the grid; returns a CUDA error code (0: none).
template <class M>
inline int march_grid(M& m, int TY, int TZ, int blocks, int min_seg,
                      dim3& grid) {
  const Geo& g = m.c.geo;
  m.ty = (m.rows[1] + TY - 1) / TY;
  m.tz = (m.rows[2] + TZ - 1) / TZ;
  const int rows = m.rows[0];
  const long long tiles = (long long)m.ty * m.tz * g.n[0] * g.n[1] * g.n[2];
  long long nseg = (blocks + tiles - 1) / tiles;
  const long long most = rows / min_seg > 1 ? rows / min_seg : 1;
  if (nseg > most) nseg = most;
  m.seg = (int)((rows + nseg - 1) / nseg);
  m.nseg = (rows + m.seg - 1) / m.seg;
  const long long gx = (long long)m.tz * g.n[2], gy = (long long)m.ty * g.n[1];
  const long long gz = (long long)m.nseg * g.n[0];
  if (gx > 0x7fffffffLL || gy > 65535 || gz > 65535)
    return (int)cudaErrorInvalidConfiguration;
  if ((long long)g.G[1] * g.G[2] > 0x7fffffffLL)  // 32-bit in-plane offsets
    return (int)cudaErrorInvalidValue;
  grid = dim3((unsigned)gx, (unsigned)gy, (unsigned)gz);
  return 0;
}

}  // namespace igg
