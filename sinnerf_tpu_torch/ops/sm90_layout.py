"""Weight layouts and launch plans of the Hopper kernels: K3 in bf16
(``csrc/fused_render_train_sm90.cu``), K4 in bf16 on the same slabs
(``csrc/fused_mlp_sm90.cu``), K1 in both dtypes (``csrc/fused_render_sm90.cu``;
bf16 on the same slabs as K3, float32 on ``slab_buffer_f32``), and the
float32 training kernels and K4 in float32 (``csrc/f32_train_sm90.cu``), at
the end of this module.

The kernels stream the MLP's weights through a ring of shared-memory stages
with one 1-D bulk copy (``cp.async.bulk``) per stage, and ``wgmma`` reads
them there through 128-byte-swizzled shared-memory descriptors.  A bulk copy
moves bytes as they lie, so the weights are laid out once per call (one
gather), already swizzled, in the order the kernels consume them: a **slab** is
the 64 input columns ``[k0, k0 + 64)`` of one weight block (all its output
rows), and ``slab_buffer`` concatenates the slabs of every product of the
MLP (``FWD_SLABS``) followed by the two head weights (``wrgb``, ``wsig``),
which the kernels read with plain loads.  ``unpack_slab_buffer`` inverts it
to ``pack_weights``' layout.

The 128-byte swizzle (``wgmma``'s ``SWIZZLE_128B``, CUTLASS's
``Swizzle<3,4,3>``): a slab row is 64 bf16 values, 128 bytes, in eight
16-byte chunks; chunk ``c`` of row ``r`` lies at chunk position
``c ^ (r % 8)``.  Every slab starts on a 1,024-byte boundary, as the
descriptor's swizzle (computed from address bits) requires.  The same bytes
serve both directions: the forward reads a slab as the K-major B operand
(row = output, 128 bytes along the input), the backward's input gradient as
the MN-major B operand (row = the reduction over outputs, 128 bytes along the
64 inputs it produces); the ``wgmma`` transpose bit tells the two apart, and
no second copy of the weights exists.

Activation tiles in shared memory use the same swizzle, ``ACT_BLOCK`` bytes
per 64 columns: column block ``k // 64`` of point ``p`` is row ``p`` of that
block (``act_offset``).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch

from sinnerf_tpu_torch.ops.fused_mlp import DIR_PAD, WEIGHT_OFFSETS, WEIGHT_SIZE, WIDTH, XYZ_PAD, PackedWeights

SW = 64  # bf16 values in one swizzled row (128 bytes)
TILE_RAYS = 128  # rays per CTA tile: two consumer warpgroups of 64
ACT_BLOCK = TILE_RAYS * SW * 2  # bytes of one 64-column block of a 128-point tile


class Slab(NamedTuple):
    block: str  # weight block of fused_mlp.WEIGHT_LAYOUT
    k0: int  # first input column
    rows: int  # output rows (256, or 128 for the direction layer)

    @property
    def nbytes(self) -> int:
        return self.rows * SW * 2


def _slabs_of(block: str) -> List[Slab]:
    _, (rows, cols) = WEIGHT_OFFSETS[block]
    return [Slab(block, k0, rows) for k0 in range(0, cols, SW)]


# The forward's products, in the order the kernels run them: layer 1 on the
# PE, layers 2-4, layer 5 (trunk then PE: one accumulator), 6-8,
# xyz_encoding_final, the direction layer (trunk then the direction PE, whose
# 32 padded columns fill one slab with zeros past column 32).
FWD_BLOCKS = ("w1", "w2", "w3", "w4", "w5h", "w5x", "w6", "w7", "w8", "wfin", "wdh", "wdx")
FWD_SLABS: Tuple[Slab, ...] = tuple(s for b in FWD_BLOCKS for s in _slabs_of(b))
# The backward's input gradients read the trunk's blocks again, from the
# direction layer down to layer 2 (no gradient reaches the PE): indices into
# FWD_SLABS, in the order the backward consumes them.
BWD_BLOCKS = ("wdh", "wfin", "w8", "w7", "w6", "w5h", "w4", "w3", "w2")
BWD_SLABS: Tuple[int, ...] = tuple(i for b in BWD_BLOCKS for i, s in enumerate(FWD_SLABS) if s.block == b)
HEAD_BLOCKS = ("wrgb", "wsig")


def slab_offsets(slabs=FWD_SLABS) -> Tuple[List[int], int]:
    """Byte offset of each of ``slabs`` in their buffer (``slab_buffer`` for
    FWD_SLABS), and of the head weights after them."""
    offs, at = [], 0
    for s in slabs:
        offs.append(at)
        at += s.nbytes
    return offs, at


SLAB_OFFSETS, HEAD_OFFSET = slab_offsets()
HEAD_SIZE = sum(WEIGHT_OFFSETS[b][1][0] * WEIGHT_OFFSETS[b][1][1] for b in HEAD_BLOCKS)
SLAB_BUFFER_SIZE = HEAD_OFFSET // 2 + HEAD_SIZE  # bf16 values


def swizzle_index(rows: int, device=None) -> torch.Tensor:
    """For a (rows, 64) row-major tile, the position of each element in its
    swizzled image: ``r * 64 + ((c ^ (r % 8)) * 8) + e`` for column ``8c + e``."""
    r = torch.arange(rows, device=device)[:, None]
    col = torch.arange(SW, device=device)[None, :]
    return (r * SW + ((col // 8) ^ (r % 8)) * 8 + col % 8).reshape(-1)


def swizzle(tile: torch.Tensor) -> torch.Tensor:
    """(rows, 64) -> its swizzled image, flat."""
    out = torch.empty(tile.numel(), dtype=tile.dtype, device=tile.device)
    out[swizzle_index(tile.shape[0], tile.device)] = tile.reshape(-1)
    return out


def unswizzle(flat: torch.Tensor, rows: int) -> torch.Tensor:
    """The inverse of ``swizzle``: (rows, 64)."""
    return flat[swizzle_index(rows, flat.device)].view(rows, SW)


def _block(w: torch.Tensor, name: str) -> torch.Tensor:
    off, (rows, cols) = WEIGHT_OFFSETS[name]
    return w[off : off + rows * cols].view(rows, cols)


def _gather_index() -> torch.Tensor:
    """For each value of the slab buffer, its position in ``pack_weights``'
    buffer, or WEIGHT_SIZE for a zero past a block's last column."""
    idx = torch.full((SLAB_BUFFER_SIZE,), WEIGHT_SIZE, dtype=torch.int64)
    for s, off in zip(FWD_SLABS, SLAB_OFFSETS):
        boff, (rows, cols) = WEIGHT_OFFSETS[s.block]
        col = s.k0 + torch.arange(SW)[None, :]
        src = torch.where(col < cols, boff + torch.arange(rows)[:, None] * cols + col, WEIGHT_SIZE)
        idx[off // 2 + swizzle_index(rows)] = src.reshape(-1)
    at = HEAD_OFFSET // 2
    for b in HEAD_BLOCKS:
        boff, (rows, cols) = WEIGHT_OFFSETS[b]
        idx[at : at + rows * cols] = torch.arange(boff, boff + rows * cols)
        at += rows * cols
    return idx


_GATHER: Dict[torch.device, torch.Tensor] = {}


def slab_buffer(packed: PackedWeights) -> torch.Tensor:
    """``pack_weights``' bf16 weights -> the kernels' slab buffer (bf16,
    SLAB_BUFFER_SIZE values): every slab of FWD_SLABS swizzled, zero past a
    block's last column, then wrgb and wsig as packed.  One gather with an
    index built once per device (the training step builds the buffer once
    per level)."""
    w = packed.w
    if w.dtype != torch.bfloat16 or w.shape != (WEIGHT_SIZE,):
        raise ValueError(f"slab_buffer takes pack_weights' bfloat16 ({WEIGHT_SIZE},) weights, got {w.dtype} {tuple(w.shape)}")
    if w.device not in _GATHER:
        _GATHER[w.device] = _gather_index().to(w.device)
    return torch.cat([w, w.new_zeros(1)])[_GATHER[w.device]]


def unpack_slab_buffer(buf: torch.Tensor) -> torch.Tensor:
    """The inverse of ``slab_buffer``: ``pack_weights``' (WEIGHT_SIZE,) layout."""
    if buf.shape != (SLAB_BUFFER_SIZE,):
        raise ValueError(f"a slab buffer has {SLAB_BUFFER_SIZE} values, got {tuple(buf.shape)}")
    w = torch.zeros(WEIGHT_SIZE, dtype=buf.dtype, device=buf.device)
    for s, off in zip(FWD_SLABS, SLAB_OFFSETS):
        tile = unswizzle(buf[off // 2 : off // 2 + s.rows * SW], s.rows)
        blk = _block(w, s.block)
        cols = min(SW, blk.shape[1] - s.k0)
        blk[:, s.k0 : s.k0 + cols] = tile[:, :cols]
    at = HEAD_OFFSET // 2
    for b in HEAD_BLOCKS:
        blk = _block(w, b)
        blk.copy_(buf[at : at + blk.numel()].view_as(blk))
        at += blk.numel()
    return w


def act_offset(p: int, k: int) -> int:
    """Byte offset of (point p, column k) in a swizzled 128-point bf16
    activation tile: block k // 64, row p, chunk (k % 64) // 8 at position
    chunk ^ (p % 8)."""
    return (k // SW) * ACT_BLOCK + p * 128 + ((((k % SW) // 8) ^ (p % 8)) * 16) + (k % 8) * 2


# ---------------------------------------------------------------- launch plan
# Shared memory of one CTA, bytes (csrc/fused_render_train_sm90.cu's
# FwdSmem/BwdSmem; the wrapper holds the two together on the card):
ACT_BYTES = 4 * ACT_BLOCK  # a 128 x 256 activation or delta tile
PE_BYTES = ACT_BLOCK  # a 128 x 64 PE tile
STAGE_BYTES = 256 * SW * 2  # one ring stage: the largest slab
FWD_STAGES, BWD_STAGES = 3, 2
SMALL_BYTES = 8192  # rays, per-point head cotangents, barriers
ALIGN_SLACK = 1024  # the dynamic base is aligned to 1,024 bytes by hand
FWD_SMEM = ACT_BYTES + 2 * PE_BYTES + FWD_STAGES * STAGE_BYTES + SMALL_BYTES + ALIGN_SLACK
BWD_SMEM = 2 * ACT_BYTES + PE_BYTES + BWD_STAGES * STAGE_BYTES + SMALL_BYTES + ALIGN_SLACK
N_KEPT = 9  # h1..h8 and xyz_encoding_final, kept per CTA for the backward
HALF = 128
# global scratch per CTA of the backward: the kept tiles (their shared-memory
# images) and the per-ray f32 sum of the direction delta
BWD_SCRATCH = N_KEPT * ACT_BYTES + TILE_RAYS * HALF * 4
THREADS = 384  # two consumer warpgroups and one producer warpgroup


# A backward unit's work besides its sample passes (the rays, stage A over
# the samples from the last down to the range's first, the starting
# transmittance, the unit's dwdx flush), counted in sample passes: the split
# weighs it, so that a near tie goes to fewer, longer ranges.  On an H100 a
# unit costs 59-65 us beside 0.357 ms a sample pass (16,384 and 18,776 rays
# x 64, 1 to 64 ranges).
BWD_UNIT_PASSES = 0.17


def bwd_chunks(tiles: int, s: int, sm_count: int) -> int:
    """The sample ranges per ray tile of the bf16 backward: 1 when the tiles
    fit on the SMs; otherwise the divisor c of s whose units (tiles x c, s / c
    samples each, walked ctas apart) give the least work to the busiest CTA,
    ceil(tiles c / sm_count) (s / c + BWD_UNIT_PASSES), the fewest ranges on
    a tie."""
    if tiles <= sm_count:
        return 1
    best, chunks = None, 1
    for c in range(1, s + 1):
        if s % c == 0:
            cost = -(-tiles * c // sm_count) * (s // c + BWD_UNIT_PASSES)
            if best is None or cost < best:
                best, chunks = cost, c
    return chunks


def launch_plan(n: int, s: int, sm_count: int) -> Dict[str, int]:
    """What one launch of either kernel runs for n rays x s samples on a card
    of ``sm_count`` SMs: ray tiles, persistent CTAs (one per SM at most, each
    walking tiles ctas apart), the most tiles one CTA runs, slabs streamed per
    CTA (forward and backward), and the backward's scratch bytes.  The bf16
    backward cuts each tile's samples into ``chunks`` equal ranges
    (``bwd_chunks``) and its CTAs walk the ``units`` (tile u // chunks, range
    u % chunks) ctas apart: the most units and sample passes one CTA runs."""
    if n < 0 or s < 1 or sm_count < 1:
        raise ValueError(f"launch_plan: n={n}, s={s}, sm_count={sm_count}")
    tiles = -(-n // TILE_RAYS)
    ctas = min(tiles, sm_count)
    per_cta = -(-tiles // ctas) if ctas else 0
    chunks = bwd_chunks(tiles, s, sm_count)
    units_per_cta = -(-tiles * chunks // ctas) if ctas else 0
    return dict(
        tiles=tiles, ctas=ctas, threads=THREADS, tiles_per_cta=per_cta,
        fwd_slabs_per_cta=per_cta * s * len(FWD_SLABS),
        chunks=chunks, units=tiles * chunks, bwd_units_per_cta=units_per_cta,
        bwd_passes_per_cta=units_per_cta * (s // chunks),
        bwd_slabs_per_cta=units_per_cta * (s // chunks) * (len(FWD_SLABS) + len(BWD_SLABS)),
        fwd_smem=FWD_SMEM, bwd_smem=BWD_SMEM, scratch_bytes=ctas * BWD_SCRATCH,
    )


# ------------------------------------------- K4-fwd bf16 (csrc/fused_mlp_sm90.cu)
# K4-bwd bf16's recompute without keeping, on K3-fwd bf16's CTA and shared
# memory (FWD_SMEM): the producer streams FWD_SLABS per tile, the sigma-only
# pass the slabs of w1 .. w8 (layers 1..8 and the sigma head), the first 30.
K4_SIGMA_SLABS: Tuple[int, ...] = tuple(i for i, s in enumerate(FWD_SLABS) if s.block not in ("wfin", "wdh", "wdx"))


def k4_fwd_launch_plan(n: int, sm_count: int, sigma_only: bool) -> Dict[str, int]:
    """What one launch of the bf16 K4-fwd runs for n points on a card of
    ``sm_count`` SMs: tiles of 128 points, persistent CTAs (one per SM at
    most, each walking tiles ctas apart), threads and shared memory of a CTA
    (K3-fwd bf16's), the most tiles one CTA runs and the slabs it streams."""
    plan = launch_plan(n, 1, sm_count)
    slabs = len(K4_SIGMA_SLABS) if sigma_only else len(FWD_SLABS)
    return dict(
        tiles=plan["tiles"], ctas=plan["ctas"], threads=THREADS, smem=FWD_SMEM,
        tiles_per_cta=plan["tiles_per_cta"], slabs_per_cta=plan["tiles_per_cta"] * slabs,
    )


# ------------------------------------------- K4-bwd bf16 (csrc/fused_mlp_sm90.cu)
# K3-bwd bf16's CTA at one sample per ray.  After the recompute's FWD_SLABS the
# producer streams K3's backward slabs and three that K3 never reads, each the
# MN-major B of a one-slab dgrad for K4's input gradients: wdx (ddpe = da_d
# Wdx) before the direction layer's, w5x (da5 W5x) before w5h's, w1 (+ da1 W1)
# last.  Indices into FWD_SLABS, in the producer's order (fused_mlp_sm90.cu's
# k4_bwd_slab; the wrapper holds the two together when it loads the kernel).
K4_BWD_BLOCKS = ("wdx",) + BWD_BLOCKS[:5] + ("w5x",) + BWD_BLOCKS[5:] + ("w1",)
K4_BWD_SLABS: Tuple[int, ...] = tuple(i for b in K4_BWD_BLOCKS for i, s in enumerate(FWD_SLABS) if s.block == b)
# global scratch per CTA: K3's (the kept tiles, then da_d per point in f32),
# then the input gradients dxpe [128][64] and ddpe [128][32] in f32
K4_BWD_SCRATCH = BWD_SCRATCH + TILE_RAYS * (XYZ_PAD + DIR_PAD) * 4


def k4_bwd_launch_plan(n: int, sm_count: int) -> Dict[str, int]:
    """What one launch of the bf16 K4-bwd runs for n points on a card of
    ``sm_count`` SMs: tiles of 128 points, persistent CTAs (one per SM at
    most, each walking tiles ctas apart), threads and shared memory of a CTA
    (K3-bwd bf16's), the most tiles one CTA runs, the slabs it streams and
    the launch's global scratch."""
    plan = launch_plan(n, 1, sm_count)
    return dict(
        tiles=plan["tiles"], ctas=plan["ctas"], threads=THREADS, smem=BWD_SMEM, tiles_per_cta=plan["tiles_per_cta"],
        slabs_per_cta=plan["tiles_per_cta"] * (len(FWD_SLABS) + len(K4_BWD_SLABS)),
        scratch_bytes=plan["ctas"] * K4_BWD_SCRATCH,
    )


# --------------------------------------------------------- float32 (K1 f32)
# csrc/mlp_f32_sm90.cuh streams the float32 weights as slabs of F32_ROWS
# input rows of one block with every output column, transposed to K-major
# [k][out] f32: element (row k0 + kk, output o) of slab (block, k0, out) lies
# at byte 4 * (kk * out + o) from the slab's start.  ``slab_buffer_f32``
# concatenates the slabs in the order the kernel consumes them (F32_SLABS:
# the forward's blocks, FWD_BLOCKS, 16 rows at a time), then wrgb and wsig as
# packed.  Every block's padded width is a multiple of 16, so the buffer is a
# permutation of ``pack_weights``' float32 buffer: WEIGHT_SIZE values, no
# padding of its own.  The kernel's static_asserts and ``k1_sm90_slab_elems``
# hold it to these numbers.
F32_ROWS = 16


class F32Slab(NamedTuple):
    block: str  # weight block of fused_mlp.WEIGHT_LAYOUT
    k0: int  # first input column of the block (first row of the slab)
    out: int  # output columns (256, or 128 for the direction layer)

    @property
    def nbytes(self) -> int:
        return F32_ROWS * self.out * 4


def _f32_slabs_of(block: str) -> List[F32Slab]:
    _, (rows, cols) = WEIGHT_OFFSETS[block]
    return [F32Slab(block, k0, rows) for k0 in range(0, cols, F32_ROWS)]


F32_SLABS: Tuple[F32Slab, ...] = tuple(s for b in FWD_BLOCKS for s in _f32_slabs_of(b))
F32_SLAB_OFFSETS, F32_HEAD_OFFSET = slab_offsets(F32_SLABS)
SLAB_BUFFER_F32_SIZE = F32_HEAD_OFFSET // 4 + HEAD_SIZE  # float32 values


def _gather_index_f32() -> torch.Tensor:
    """For each value of the float32 slab buffer, its position in
    ``pack_weights``' buffer."""
    idx = torch.empty(SLAB_BUFFER_F32_SIZE, dtype=torch.int64)
    for s, off in zip(F32_SLABS, F32_SLAB_OFFSETS):
        boff, (rows, cols) = WEIGHT_OFFSETS[s.block]
        kk = torch.arange(F32_ROWS)[:, None]
        o = torch.arange(rows)[None, :]
        idx[off // 4 : off // 4 + F32_ROWS * rows] = (boff + o * cols + s.k0 + kk).reshape(-1)
    at = F32_HEAD_OFFSET // 4
    for b in HEAD_BLOCKS:
        boff, (rows, cols) = WEIGHT_OFFSETS[b]
        idx[at : at + rows * cols] = torch.arange(boff, boff + rows * cols)
        at += rows * cols
    return idx


_GATHER_F32: Dict[torch.device, torch.Tensor] = {}


def slab_buffer_f32(packed: PackedWeights) -> torch.Tensor:
    """``pack_weights``' float32 weights -> K1 f32's slab buffer (float32,
    SLAB_BUFFER_F32_SIZE values): every slab of F32_SLABS as [16][out], then
    wrgb and wsig as packed.  One gather with an index built once per
    device."""
    w = packed.w
    if w.dtype != torch.float32 or w.shape != (WEIGHT_SIZE,):
        raise ValueError(f"slab_buffer_f32 takes pack_weights' float32 ({WEIGHT_SIZE},) weights, got {w.dtype} "
                         f"{tuple(w.shape)}")
    if w.device not in _GATHER_F32:
        _GATHER_F32[w.device] = _gather_index_f32().to(w.device)
    return w[_GATHER_F32[w.device]]


def unpack_slab_buffer_f32(buf: torch.Tensor) -> torch.Tensor:
    """The inverse of ``slab_buffer_f32``: ``pack_weights``' (WEIGHT_SIZE,)
    layout."""
    if buf.shape != (SLAB_BUFFER_F32_SIZE,):
        raise ValueError(f"a float32 slab buffer has {SLAB_BUFFER_F32_SIZE} values, got {tuple(buf.shape)}")
    w = torch.zeros(WEIGHT_SIZE, dtype=buf.dtype, device=buf.device)
    for s, off in zip(F32_SLABS, F32_SLAB_OFFSETS):
        tile = buf[off // 4 : off // 4 + F32_ROWS * s.out].view(F32_ROWS, s.out)
        _block(w, s.block)[:, s.k0 : s.k0 + F32_ROWS] = tile.T
    at = F32_HEAD_OFFSET // 4
    for b in HEAD_BLOCKS:
        blk = _block(w, b)
        blk.copy_(buf[at : at + blk.numel()].view_as(blk))
        at += blk.numel()
    return w


# Shared memory of one K1 f32 CTA, bytes (csrc/mlp_f32_sm90.cuh Smem): the
# [k][point] activation tile, the PE tile (the sample PE, then the direction
# PE), a ring of F32_STAGES slabs of 256 outputs, then rays, the heads'
# partial sums of two warp columns and the ring's barriers.
F32_STAGES = 3
F32_THREADS = 384  # two consumer warpgroups (eight warps) and the producer warpgroup
K1_F32_SMEM = (4 * WIDTH * TILE_RAYS + 4 * 64 * TILE_RAYS + F32_STAGES * F32_ROWS * WIDTH * 4
               + 4 * TILE_RAYS * (6 + 2 + 2 * 3) + 64)


def k1_launch_plan(n: int, s: int, sm_count: int, compute_dtype: str) -> Dict[str, int]:
    """What one K1 launch runs for n rays x s samples on a card of
    ``sm_count`` SMs: ray tiles of 128, persistent CTAs (one per SM at most,
    each walking tiles ctas apart), threads and shared memory of a CTA, the
    most tiles one CTA runs and the slabs it streams."""
    if compute_dtype not in ("bfloat16", "float32"):
        raise ValueError(f"k1_launch_plan: compute_dtype {compute_dtype!r}")
    bf16 = compute_dtype == "bfloat16"
    plan = launch_plan(n, s, sm_count)
    slabs = len(FWD_SLABS) if bf16 else len(F32_SLABS)
    return dict(
        tiles=plan["tiles"], ctas=plan["ctas"], tiles_per_cta=plan["tiles_per_cta"],
        threads=THREADS if bf16 else F32_THREADS, smem=FWD_SMEM if bf16 else K1_F32_SMEM,
        slabs_per_cta=plan["tiles_per_cta"] * s * slabs,
    )


# ------------------------------------------- float32 backward (K3-bwd, K4-bwd)
# csrc/mlp_backward_f32_sm90.cuh streams three kinds of slab through the
# ring of mlp_f32_sm90.cuh: the recompute's F32_SLABS, then per layer of the
# backward the layer input A of its wgrad, read back from the CTA's global
# scratch, and the weights of its dgrad.  A dgrad slab is F32_ROWS *output*
# rows of a block with every input column: pack_weights' row-major block cut
# by rows, so the dgrad slabs are the packed buffer's own bytes and need no
# second copy (``dgrad_slab``).  An A slab is 32 points x 128 inputs of a
# kept tile, which the recompute writes point-major in two 128-wide halves
# ([half][point][128] f32), or 64 points x 64 of the sample PE ([point][64]).


class BwdSlab(NamedTuple):
    source: str  # "kept" (the CTA's scratch) or "weights" (pack_weights' buffer)
    name: str  # kept: "h1".."h8", "f" or "x" (the sample PE); weights: a block of WEIGHT_LAYOUT
    index: int  # kept: 4 h + c (half h, point chunk c), x: c; weights: o0 // F32_ROWS
    offset: int  # bytes from the start of the scratch or of the packed float32 buffer
    nbytes: int


F32_KEPT = tuple(f"h{i}" for i in range(1, 9)) + ("f",)  # the kept tiles, in scratch order
F32_HALF_BYTES = TILE_RAYS * HALF * 4  # one half of a kept tile
F32_KEPT_BYTES = 2 * F32_HALF_BYTES
F32_XPE_OFFSET = len(F32_KEPT) * F32_KEPT_BYTES  # the sample PE [point][64], after the kept tiles
F32_MASKS_OFFSET = F32_XPE_OFFSET + TILE_RAYS * 64 * 4  # ReLU bits of h1..h8: [8][256 threads] x 16 bytes
F32_EXTRA_OFFSET = F32_MASKS_OFFSET + 8 * 256 * 16  # K3: da_d summed per ray; K4: dxpe, ddpe
F32_BWD_SCRATCH = F32_EXTRA_OFFSET + TILE_RAYS * HALF * 4  # bytes of global scratch per CTA


def _kept_slab(tile: str, h: int, c: int) -> BwdSlab:
    at = F32_KEPT.index(tile) * F32_KEPT_BYTES + h * F32_HALF_BYTES + c * F32_ROWS * WIDTH * 4
    return BwdSlab("kept", tile, 4 * h + c, at, F32_ROWS * WIDTH * 4)


def dgrad_slabs_of(block: str) -> List[BwdSlab]:
    """The dgrad slabs of one block, F32_ROWS output rows each, in order."""
    boff, (rows, cols) = WEIGHT_OFFSETS[block]
    return [BwdSlab("weights", block, r, 4 * (boff + r * F32_ROWS * cols), 4 * F32_ROWS * cols)
            for r in range(rows // F32_ROWS)]


def f32_bwd_slabs(k4: bool) -> Tuple[BwdSlab, ...]:
    """The slabs of one tile's backward in the order the kernels consume them
    (``produce_bwd``): per layer, from the direction layer down to layer 1,
    the A slabs of its wgrad, then (K4, layers 5 and 1) the input gradient's
    slabs, then its dgrad slabs."""
    out: List[BwdSlab] = [_kept_slab("f", h, c) for c in range(4) for h in range(2)]  # both halves per chunk
    out += dgrad_slabs_of("wdh")
    out += [_kept_slab("h8", h, c) for h in range(2) for c in range(4)]
    out += dgrad_slabs_of("wfin")
    for layer in range(8, 0, -1):
        if layer > 1:
            out += [_kept_slab(f"h{layer - 1}", h, c) for h in range(2) for c in range(4)]
        if layer in (5, 1):
            out += [BwdSlab("kept", "x", c, F32_XPE_OFFSET + c * F32_ROWS * WIDTH * 4, F32_ROWS * WIDTH * 4)
                    for c in range(2)]
            if k4:
                out += dgrad_slabs_of("w5x" if layer == 5 else "w1")
        if layer > 1:
            out += dgrad_slabs_of("w5h" if layer == 5 else f"w{layer}")
    return tuple(out)


def dgrad_slab(w: torch.Tensor, slab: BwdSlab) -> torch.Tensor:
    """The (F32_ROWS, cols) rows of ``pack_weights``' float32 buffer ``w``
    that a dgrad slab copies, as the kernel's bulk copy reads them."""
    if slab.source != "weights":
        raise ValueError(f"{slab} is not a dgrad slab")
    cols = WEIGHT_OFFSETS[slab.name][1][1]
    start = slab.offset // 4
    return w[start : start + F32_ROWS * cols].view(F32_ROWS, cols)


# Shared memory of one float32 backward CTA, bytes (BwdSmem): K1 f32's, the
# per-point head cotangents g_sigma [128] and da_rgb [128][3] and K3's
# transmittance per ray [128].
F32_BWD_SMEM = K1_F32_SMEM + 4 * TILE_RAYS * 5


def f32_bwd_launch_plan(n: int, s: int, sm_count: int, k4: bool) -> Dict[str, int]:
    """What one launch of the float32 K3-bwd (``k4`` False: n rays x s
    samples) or K4-bwd (n points, s = 1) runs on a card of ``sm_count`` SMs:
    tiles of 128, persistent CTAs (one per SM at most, each walking tiles
    ctas apart), threads and shared memory of a CTA, the most tiles one CTA
    runs, the slabs it streams and the global scratch of the launch."""
    plan = launch_plan(n, s, sm_count)
    per_tile = len(F32_SLABS) + len(f32_bwd_slabs(k4))
    return dict(
        tiles=plan["tiles"], ctas=plan["ctas"], tiles_per_cta=plan["tiles_per_cta"], threads=F32_THREADS,
        smem=F32_BWD_SMEM, slabs_per_cta=plan["tiles_per_cta"] * s * per_tile,
        scratch_bytes=plan["ctas"] * F32_BWD_SCRATCH,
    )


# K4-fwd f32 (f32_train_sm90.cu): K4-bwd f32's recompute without keeping, on
# the backward's shared memory (BwdCta).  The sigma-only pass stops after the
# sigma head: it streams the slabs of w1 .. w8 only.
K4_F32_FWD_SMEM = F32_BWD_SMEM
K4_F32_SIGMA_SLABS = sum(1 for s in F32_SLABS if s.block not in ("wfin", "wdh", "wdx"))


def k4_fwd_f32_launch_plan(n: int, sm_count: int, sigma_only: bool) -> Dict[str, int]:
    """What one launch of the float32 K4-fwd runs for n points on a card of
    ``sm_count`` SMs: tiles of 128, persistent CTAs, threads and shared
    memory of a CTA, the most tiles one CTA runs and the slabs it streams."""
    plan = launch_plan(n, 1, sm_count)
    slabs = K4_F32_SIGMA_SLABS if sigma_only else len(F32_SLABS)
    return dict(
        tiles=plan["tiles"], ctas=plan["ctas"], threads=F32_THREADS, smem=K4_F32_FWD_SMEM,
        tiles_per_cta=plan["tiles_per_cta"], slabs_per_cta=plan["tiles_per_cta"] * slabs,
    )
