"""Position-aligned minimizer sketch planes.

Port of the JAX package's whole-sketch stage: `sketch_planes_ref` is
the plain PyTorch version of ops/sketch_jax4.py `sketch_planes`, and
`sketch_planes` is the wrapper that launches the CUDA kernel
(csrc/sketch.cu, the counterpart of the Pallas kernel in
ops/sketch_pallas.py) for tensors on the card.

Emission semantics match sketch.c:56-109 for odd k.  Emissions stay at
the position that triggered them:

  plane 0 (main): the A/B-rule old minimum emitted at position t
  plane 1 (tie):  the first tie emitted at position t
  slot n_len:     the end-of-read state emission (planes are L+1 wide)
  overflow:       some position emits >= 2 ties, or a first-window tie
                  shares its trigger with a main emission (the reference
                  orders that pair tie-first); such reads take the host
                  path.

Planes hold u32 values in int64 tensors (ops/u32.py): the minimizer
hash as a (hi, lo) pair and meta = span<<26 | qpos<<1 | strand, with
U32MAX marking an empty slot.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import u32

U32MAX = u32.U32MAX
META_Q_BITS = 25  # qpos field width; reads up to 32 Mb
# an empty window slot in the hash<<8|span event order; real events
# stay below 2**(2k+8) <= 2**62, so this sorts after every one of them
_EMPTY = (1 << 62) | 0xFF

NT4 = np.full(256, 4, dtype=np.uint8)
NT4[:4] = [0, 1, 2, 3]
for _c, _v in zip("ACGTU", [0, 1, 2, 3, 3]):
    NT4[ord(_c)] = _v
    NT4[ord(_c.lower())] = _v


def encode_batch(seqs, pad_to=None):
    """Encode reads to (B, L) nt4 codes + lengths (padding = 4/ambiguous).

    Returns numpy arrays (uint8 codes, int32 lengths)."""
    L = pad_to or max(len(s) for s in seqs)
    B = len(seqs)
    codes = np.full((B, L), 4, dtype=np.uint8)
    lens = np.zeros(B, dtype=np.int32)
    for i, s in enumerate(seqs):
        b = s.encode("latin-1") if isinstance(s, str) else s
        codes[i, : len(b)] = NT4[np.frombuffer(b, dtype=np.uint8)]
        lens[i] = len(b)
    return codes, lens


class SketchPlanes(NamedTuple):
    """Position-aligned sketch output (all (B, L+1) except n, overflow)."""
    hh: torch.Tensor      # minimizer hash hi (U32MAX = empty slot)
    hl: torch.Tensor      # minimizer hash lo
    meta: torch.Tensor    # span<<26 | qpos<<1 | strand
    t_hh: torch.Tensor    # tie plane hash hi
    t_hl: torch.Tensor
    t_meta: torch.Tensor
    n: torch.Tensor       # (B,) int32 emission count
    overflow: torch.Tensor  # (B,) bool


def _check(codes, lens, w, k):
    if k % 2 == 0:
        raise ValueError("sketch_planes requires odd k")
    if not 2 * k <= 54:
        raise ValueError("k too large for the int64 event key")
    B, L = codes.shape
    if L >= 1 << META_Q_BITS:
        raise ValueError("read length exceeds meta qpos field")
    if codes.dtype != torch.uint8 or lens.dtype != torch.int32:
        raise TypeError("codes must be uint8 and lens int32")
    if lens.shape != (B,) or lens.device != codes.device:
        raise ValueError("lens must be (B,) on the codes' device")


def sketch_planes_ref(codes: torch.Tensor, lens: torch.Tensor, w: int,
                      k: int) -> SketchPlanes:
    """Plain PyTorch sketch (ops/sketch_jax4.py sketch_planes).

    codes: (B, L) uint8 nt4 codes; lens: (B,) int32.  Odd k only."""
    _check(codes, lens, w, k)
    B, L = codes.shape
    dev = codes.device
    mask2k = (1 << (2 * k)) - 1
    I64 = torch.int64
    pos = torch.arange(L, dtype=I64, device=dev)[None, :]
    n_len = lens.to(I64)[:, None]
    in_range = pos < n_len
    valid = (codes < 4) & in_range
    c = torch.where(valid, codes.to(I64), 0)

    def shift_pos(a, d, fill):
        """out[:, i] = a[:, i-d]; the first d columns get fill."""
        if d == 0:
            return a
        d = min(d, L)
        pad = torch.full((B, d), fill, dtype=a.dtype, device=dev)
        return torch.cat([pad, a[:, : L - d]], dim=1)

    kf = torch.zeros((B, L), dtype=I64, device=dev)
    kr = torch.zeros((B, L), dtype=I64, device=dev)
    for d in range(k):
        cd = shift_pos(c, d, 0)
        kf = kf | (cd << (2 * d))
        kr = kr | ((cd ^ 3) << (2 * (k - 1 - d)))

    # run length of valid bases ending at each position
    last_bad = torch.cummax(torch.where(valid, -1, pos.expand(B, L)),
                            dim=1).values
    l = torch.where(last_bad >= 0, pos - last_bad, pos + 1)

    z = kf >= kr
    h = u32.hash64(torch.where(z, kr, kf), mask2k)
    span = torch.clamp(l, max=k)
    has_info = in_range & valid & (l >= k)
    # event key ex = hash<<8|span keeps the reference comparison order
    ex = torch.where(has_info, (h << 8) | span, _EMPTY)
    emeta = torch.where(has_info,
                        (span << (META_Q_BITS + 1)) | (pos << 1)
                        | z.to(I64), U32MAX)

    pxh = torch.cat([torch.full((B, w), _EMPTY, dtype=I64, device=dev),
                     ex], dim=1)
    pym = torch.cat([torch.full((B, w), U32MAX, dtype=I64, device=dev),
                     emeta], dim=1)

    def win(a, j):
        return a[:, j + 1: j + 1 + L]

    # newest minimum over the window of w events ending at t
    mh, mym = win(pxh, 0), win(pym, 0)
    mj = torch.zeros((B, L), dtype=I64, device=dev)
    for j in range(1, w):
        nh = win(pxh, j)
        take = nh <= mh
        mh = torch.where(take, nh, mh)
        mym = torch.where(take, win(pym, j), mym)
        mj = torch.where(take, j, mj)
    m_ev = pos - w + 1 + mj

    pmh = shift_pos(mh, 1, _EMPTY)
    pmym = shift_pos(mym, 1, U32MAX)
    pme = shift_pos(m_ev.expand(B, L), 1, -1)

    pmv_ok = pmh != _EMPTY
    mval_ok = mh != _EMPTY
    A_cond = ex <= pmh
    B_cond = in_range & ~A_cond & (pme == pos - w)
    emitA = in_range & A_cond & (l >= w + k) & pmv_ok
    emitB = B_cond & (l >= w + k - 1) & pmv_ok

    b_base = B_cond & (l >= w + k - 1) & mval_ok
    fw = in_range & (l == w + k - 1) & pmv_ok
    # fold the (2w-1) tie slots into (first-tie, tie-count) planes
    tie_x = torch.full((B, L), _EMPTY, dtype=I64, device=dev)
    tie_m = torch.full((B, L), U32MAX, dtype=I64, device=dev)
    tie_n = torch.zeros((B, L), dtype=torch.int32, device=dev)
    tie_fw = torch.zeros((B, L), dtype=torch.bool, device=dev)

    def add_tie(cond, vx, vm, tx, tm, tn):
        first = cond & (tn == 0)
        return (torch.where(first, vx, tx), torch.where(first, vm, tm),
                tn + cond.to(torch.int32))

    for j in range(w):
        wx_j, wym_j = win(pxh, j), win(pym, j)
        if j < w - 1:
            ft = fw & (wx_j == pmh) & (wym_j != pmym)
            tie_x, tie_m, tie_n = add_tie(ft, wx_j, wym_j, tie_x, tie_m,
                                          tie_n)
            tie_fw = tie_fw | ft
        bt = b_base & (wx_j == mh) & (wym_j != mym)
        tie_x, tie_m, tie_n = add_tie(bt, wx_j, wym_j, tie_x, tie_m, tie_n)

    main_emit = emitA | emitB
    out_x = torch.where(main_emit, pmh, _EMPTY)
    out_m = torch.where(main_emit, pmym, U32MAX)

    # final state emission parked at free slot n_len (plane width L+1)
    last_i = torch.clamp(n_len - 1, min=0)
    fin_x = torch.gather(mh, 1, last_i)
    fin_ok = (n_len > 0) & (fin_x != _EMPTY)
    pad_x = torch.where(fin_ok, fin_x, _EMPTY)
    pad_m = torch.where(fin_ok, torch.gather(mym, 1, last_i), U32MAX)
    slot = torch.arange(L + 1, dtype=I64, device=dev)[None, :]
    at_fin = slot == n_len
    ex_col = torch.full((B, 1), _EMPTY, dtype=I64, device=dev)
    um_col = torch.full((B, 1), U32MAX, dtype=I64, device=dev)
    # NB: the widening slot L stays EMPTY unless n_len == L
    out_x = torch.where(at_fin, pad_x, torch.cat([out_x, ex_col], 1))
    out_m = torch.where(at_fin, pad_m, torch.cat([out_m, um_col], 1))
    tie_x = torch.cat([tie_x, ex_col], 1)
    tie_m = torch.cat([tie_m, um_col], 1)

    n = (main_emit.sum(1) + torch.clamp(tie_n, max=1).sum(1)
         + fin_ok[:, 0]).to(torch.int32)
    overflow = (tie_n > 1).any(1) | (tie_fw & main_emit).any(1)

    def unpack(x, m):
        hsh = x >> 8
        empty = m == U32MAX
        return (torch.where(empty, U32MAX, hsh >> 32),
                torch.where(empty, U32MAX, hsh & U32MAX))

    hh, hl = unpack(out_x, out_m)
    thh, thl = unpack(tie_x, tie_m)
    return SketchPlanes(hh, hl, out_m, thh, thl, tie_m, n, overflow)


def sketch_planes(codes: torch.Tensor, lens: torch.Tensor, w: int,
                  k: int) -> SketchPlanes:
    """Sketch planes: the plain version for CPU tensors, the CUDA
    kernel (csrc/sketch.cu) for tensors on the card."""
    if codes.device.type == "cpu":
        return sketch_planes_ref(codes, lens, w, k)
    _check(codes, lens, w, k)
    from .. import kernels
    B, L = codes.shape
    codes = codes.contiguous()
    lens = lens.contiguous()

    # one allocation for the six planes and one for the two counters
    hh, hl, meta, thh, thl, tmeta = torch.empty(
        (6, B, L + 1), dtype=torch.int64, device=codes.device).unbind(0)
    n, ovf = torch.zeros((2, B), dtype=torch.int32,
                         device=codes.device).unbind(0)
    kernels.launch("sketch", codes, lens, B, L, w, k, hh, hl, meta,
                   thh, thl, tmeta, n, ovf)
    return SketchPlanes(hh, hl, meta, thh, thl, tmeta, n, ovf != 0)
