// The segment table of a chunk: S scaffolds laid end to end on the
// position axis of [M, ..., Ltot] arrays (the batch engine, K5), with
// per-scaffold offsets and keys; a single scaffold is a chunk of one
// segment. Nothing is padded to a common length.
//
// The table is one int64 array of 4 * (S + 1) entries:
//   off[0..S]     position offsets (off[S] = Ltot)
//   tile0[0..S]   the first tile of each segment (tile0[S] = tiles in all)
//   key[0..S-1]   the segment's uint32[2] key as (k0 << 32) | k1, then 0
//   btile0[0..S]  the first big tile (kBigTile positions) of each segment
// A chunk of one segment needs no table (a null pointer): the segment is
// the whole axis, under the key passed beside it, so a one-scaffold launch
// copies nothing to the device first.
// pos0, passed beside the table, is the base of every segment's position
// count for the rarefied draws: 0 for a whole scaffold, the shard's first
// position for a shard of one scaffold's positions (parallel/mesh.py), so
// that a shard draws at the scaffold's own positions.
// Position-tiled kernels launch one block per tile of kTile positions, or
// of kBigTile (mm_aggregates); a tile never spans two segments, so a
// block reduces into one segment.

#pragma once

#include <stdint.h>

namespace instrain {

constexpr int kTile = 256;
constexpr int kBigTile = 2048;

struct Segments {
    const int64_t* table;          // null: one segment over [0, L)
    int S;
    int64_t L;                     // positions in all (Ltot)
    uint64_t key0;                 // the one segment's key (no table)
    int64_t pos0;                  // base of the draws' position count
};

inline Segments segments(const void* table, int S, int64_t L,
                         uint64_t key0 = 0, int64_t pos0 = 0) {
    return Segments{(const int64_t*)table, S, L, key0, pos0};
}

__device__ __forceinline__ int64_t seg_off(const Segments& g, int s) {
    return g.table ? g.table[s] : (s == 0 ? 0 : g.L);
}

__device__ __forceinline__ int64_t seg_tile0(const Segments& g, int s) {
    return g.table ? g.table[g.S + 1 + s]
                   : (s == 0 ? 0 : (g.L + kTile - 1) / kTile);
}

__device__ __forceinline__ uint64_t seg_key(const Segments& g, int s) {
    return g.table ? (uint64_t)g.table[2 * (g.S + 1) + s] : g.key0;
}

// the segment holding `tile`: the last s with tile0[s] <= tile
__device__ __forceinline__ int segment_of_tile(const Segments& g,
                                               int64_t tile) {
    int lo = 0, hi = g.S - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (seg_tile0(g, mid) <= tile) lo = mid; else hi = mid - 1;
    }
    return lo;
}

__device__ __forceinline__ int64_t seg_btile0(const Segments& g, int s) {
    return g.table ? g.table[3 * (g.S + 1) + s]
                   : (s == 0 ? 0 : (g.L + kBigTile - 1) / kBigTile);
}

// the segment holding big tile `tile`: the last s with btile0[s] <= tile
__device__ __forceinline__ int segment_of_btile(const Segments& g,
                                                int64_t tile) {
    int lo = 0, hi = g.S - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (seg_btile0(g, mid) <= tile) lo = mid; else hi = mid - 1;
    }
    return lo;
}

// This block's tile: its segment, and the thread's position within the
// segment (p_local < len when the thread has a position)
struct TilePos {
    int s;
    int64_t p_local, len, p;       // p: position on the chunk's axis
};

__device__ __forceinline__ TilePos tile_position(const Segments& g,
                                                 int64_t tile) {
    TilePos t;
    t.s = segment_of_tile(g, tile);
    const int64_t off = seg_off(g, t.s);
    t.len = seg_off(g, t.s + 1) - off;
    t.p_local = (tile - seg_tile0(g, t.s)) * kTile + threadIdx.x;
    t.p = off + t.p_local;
    return t;
}

}  // namespace instrain
