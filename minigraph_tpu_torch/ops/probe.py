"""Equality-join probes with payload extraction: the bucketed probe of
the bucketed collect and the flat probe of `collect_anchors_flat`.

`probe_bucketed_ref` is the plain PyTorch port of the JAX package's
ops/anchors_bucketed.py `probe_xla`; `probe_bucketed` is the wrapper of
ops/probe_pallas.py `probe_bucketed_pallas`, and `probe_flat_ref` /
`probe_flat` port `probe_flat_traced` of the same module.  The wrappers
run the plain version for CPU tensors and launch the CUDA kernels
(csrc/probe.cu, the counterparts of the Pallas kernels `_make_kernel`
and `_make_flat_kernel`) for tensors on the card.

Shapes, plane-major as in the JAX package: queries sQ (9, B, SB) with
SB = nb * qb slots per read (qb per bucket), key matrix (nb, 9, KB),
payload table (nb, EXT, KB), output (EXT, B, SB), all float32.  Output
column = sum of the payload columns of the keys whose distance
D = sum_f km[f] * q[f] is zero.

Exactness: every feature and key value is an integer below 2^24, so D
is exact in any order and `D == 0` holds exactly when the query equals
the key.  Keys are unique in a bucket, so a present slot (feature 8 is
1) matches at most one key and its output is exact.  An empty spread
slot has all-zero features and matches every key of its bucket,
padding included: its output is the bucket's payload column sum, which
beyond 2^24 depends on the order of summation.  The JAX versions sum
in float32 in their own orders; the plain version here sums in float64,
which is exact for these integers, and rounds once, and the kernel
computes the same correctly rounded column sum.  `finish_anchors`
masks empty slots (`present = sf[8] > 0`), so nothing downstream reads
them.
"""
from __future__ import annotations

import torch

NF = 9                # join features per query slot
_CHUNK = 1 << 24      # (rows x keys) elements of D per plain-version step


def _check(sQ, keymat, keyext, nb):
    if sQ.dim() != 3 or sQ.shape[0] != NF:
        raise ValueError("sQ must be (9, B, SB)")
    if keymat.dim() != 3 or keymat.shape[:2] != (nb, NF):
        raise ValueError("keymat must be (nb, 9, KB)")
    if keyext.dim() != 3 or keyext.shape[0] != nb \
            or keyext.shape[2] != keymat.shape[2]:
        raise ValueError("keyext must be (nb, EXT, KB)")
    if sQ.shape[2] % nb:
        raise ValueError("SB must be a multiple of the bucket count")
    for t in (sQ, keymat, keyext):
        if t.dtype != torch.float32:
            raise TypeError("probe operands must be float32")
        if t.device != sQ.device:
            raise ValueError("probe operands must share one device")


def probe_bucketed_ref(sQ, keymat, keyext):
    """Plain PyTorch bucketed probe: (9, B, nb*qb) queries x per-bucket
    tables -> (EXT, B, nb*qb).  D and the extraction run in float64,
    which holds every product and sum exactly (TF32 never applies to
    float64 products), in chunks of query rows."""
    nb = keymat.shape[0]
    _check(sQ, keymat, keyext, nb)
    _, B, SB = sQ.shape
    KB, EXT = keymat.shape[2], keyext.shape[1]
    qb = SB // nb
    f64 = torch.float64
    q = sQ.reshape(NF, B, nb, qb).permute(2, 1, 3, 0).reshape(nb, B * qb, NF)
    out = torch.empty((nb, EXT, B * qb), dtype=torch.float32,
                      device=sQ.device)
    rows = max(1, _CHUNK // max(KB, 1))
    for v in range(nb):
        km = keymat[v].to(f64)
        ke = keyext[v].to(f64)
        for r0 in range(0, B * qb, rows):
            D = q[v, r0: r0 + rows].to(f64) @ km               # (r, KB)
            ind = (D == 0).to(f64)
            out[v, :, r0: r0 + rows] = (ke @ ind.T).to(torch.float32)
    return out.reshape(nb, EXT, B, qb).permute(1, 2, 0, 3).reshape(EXT, B, SB)


def _work(nb, n_slots, device):
    """The kernels' int32 scratch: nb present counts, then each bucket's
    list of present slots (n_slots / nb entries a bucket)."""
    return torch.empty((nb + n_slots,), dtype=torch.int32, device=device)


def probe_bucketed(sQ, keymat, keyext):
    """Bucketed probe: the plain version for CPU tensors, the CUDA
    kernel (csrc/probe.cu, entry mgt_cuda_probe_bucketed) for tensors
    on the card."""
    if sQ.device.type == "cpu":
        return probe_bucketed_ref(sQ, keymat, keyext)
    nb = keymat.shape[0]
    _check(sQ, keymat, keyext, nb)
    from .. import kernels
    _, B, SB = sQ.shape
    KB, EXT = keymat.shape[2], keyext.shape[1]
    out = torch.empty((EXT, B, SB), dtype=torch.float32, device=sQ.device)
    colsum = torch.empty((nb, EXT), dtype=torch.float32, device=sQ.device)
    work = _work(nb, B * SB, sQ.device)
    kernels.launch("probe_bucketed", sQ.contiguous(), keymat.contiguous(),
                   keyext.contiguous(), B, SB, nb, KB, EXT, colsum, work, out)
    return out


def _flat_tables(km_p, ke_p):
    """JoinIndex.km_p / ke_p, (1, 9, Kpad) or (9, Kpad), as one bucket."""
    km = km_p if km_p.dim() == 3 else km_p[None]
    ke = ke_p if ke_p.dim() == 3 else ke_p[None]
    if km.shape[0] != 1 or ke.shape[0] != 1:
        raise ValueError("flat probe tables hold one bucket")
    return km, ke


def probe_flat_ref(sQ, km_p, ke_p):
    """Plain flat probe: (9, B, qcap) queries x the whole key table ->
    (EXT, B, qcap); the bucketed probe with one bucket."""
    return probe_bucketed_ref(sQ, *_flat_tables(km_p, ke_p))


def probe_flat(sQ, km_p, ke_p):
    """Flat probe: the plain version for CPU tensors, the CUDA kernel
    (csrc/probe.cu, entry mgt_cuda_probe_flat) for tensors on the card."""
    km, ke = _flat_tables(km_p, ke_p)
    if sQ.device.type == "cpu":
        return probe_bucketed_ref(sQ, km, ke)
    _check(sQ, km, ke, 1)
    from .. import kernels
    _, B, qcap = sQ.shape
    Kpad, EXT = km.shape[2], ke.shape[1]
    out = torch.empty((EXT, B, qcap), dtype=torch.float32, device=sQ.device)
    colsum = torch.empty((EXT,), dtype=torch.float32, device=sQ.device)
    work = _work(1, B * qcap, sQ.device)
    kernels.launch("probe_flat", sQ.contiguous(), km.contiguous(),
                   ke.contiguous(), B, qcap, Kpad, EXT, colsum, work, out)
    return out
