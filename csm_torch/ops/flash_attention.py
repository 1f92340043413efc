"""Causal GQA flash attention, forward and backward: CUDA kernels, their
plain versions, and the autograd Function over them.

Sequences of S >= ``FLASH_MIN_SEQ`` tokens (prefill over the backbone cache,
and the uncached training pass) attend through ``flash_gqa_attention``, with
the mask taken from integer positions (``kv_pos <= q_pos``) instead of a
materialized (S, T) mask.  Three kernels, each the port of a TPU kernel of
the JAX package's ``ops/flash_attention.py``:

  * ``flash_attention_fwd`` → ``csrc/flash_attention.cu`` (``_kernel``): the
    output and the per-row log-sum-exp L;
  * ``flash_attention_bwd_dq`` → ``csrc/flash_attention_bwd.cu``
    (``_dq_kernel``): dq from p = exp(s − L) recomputed per key tile;
  * ``flash_attention_bwd_dkv`` → the same source (``_dkv_kernel``): dk and
    dv, summed over each kv head's query heads inside the kernel.

All three kernels take bf16 on the tensor cores and float32 on the CUDA
cores.  Like the JAX kernels, they round p (and ds) to the operands' dtype
before the products that take them: O = p·V in the forward (its row sum l
keeps the unrounded p), dq = ds·K, dk = dsᵀ·Q and dv = pᵀ·dO in the
backward; the plain versions do the same, which changes nothing in
float32.  The forward kernel rounds p = exp(s − m) against the running row
max m, the plain version against the final one, so in bf16 their p may
round apart (see ``flash_attention_plain``).

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU tensor
it computes the plain version.  There is no fallback between the two and no
switch to another backward.  The row sums Dr = Σ_d dO·O (minus the LSE
cotangent, when there is one) are plain tensor ops outside the kernels, as
in the JAX package.  Positions get no gradient.
"""

from __future__ import annotations

import ctypes
import math

import torch

from csm_torch.utils.cuda_build import load_library

SOURCE = "flash_attention.cu"
BWD_SOURCE = "flash_attention_bwd.cu"
FLASH_MIN_SEQ = 256
L_EMPTY = 1e30  # LSE of a row that sees no key
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)

# kernel launches since the last reset (read by chip_smoke.py)
launches = 0  # forward
dq_launches = 0
dkv_launches = 0


def _rounded(x, dtype):
    """x rounded to the operands' dtype, back in float32, as the JAX kernels
    round p and ds before the products that take them (a no-op in
    float32)."""
    return x.to(dtype).float()


def flash_attention_plain(q, k, v, q_pos, kv_pos):
    """The forward kernel's function in plain PyTorch.

    q (B, S, Hq, D), k/v (B, T, Hkv, D), q_pos (B, S) int, kv_pos (T,) or
    (B, T) int → (out (B, S, Hq, D) in q's dtype, lse (B, Hq, S) float32).
    Scale applied after the dot; a row with no visible key gives zeros and
    lse = L_EMPTY.  p = exp(s − m) against the row's final max m is rounded
    to q's dtype before the P·V product, as the JAX kernel rounds p
    (against its running max); the row sum l and lse keep the unrounded
    p."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if kv_pos.dim() == 1:
        kv_pos = kv_pos[None, :].expand(B, T)
    vis = kv_pos[:, None, :] <= q_pos[:, :, None]  # (B, S, T)
    s = torch.einsum("bskgd,btkd->bskgt", q.float().reshape(B, S, Hkv, G, D), k.float())
    s = (s * (1.0 / math.sqrt(D))).masked_fill(~vis[:, :, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bskgt,btkd->bskgd", _rounded(p, q.dtype), v.float())
    out = out / torch.where(l > 0, l, 1.0)
    lse = torch.where(l > 0, m + torch.log(l), torch.full_like(l, L_EMPTY))
    lse = lse.reshape(B, S, Hq).transpose(1, 2).contiguous()
    return out.reshape(B, S, Hq, D).to(q.dtype), lse


# bf16 forward against its plain version: both round p = exp(s - m) to bf16
# before O = P·V and sum l from the unrounded p, but the kernel takes m as
# the running row max over its key tiles and the plain version the final
# max, so a term p_j·v_jd of an element rounds apart by up to two bf16
# half-ulps of p (2**-8 of it, ~2**-8.3 RMS for independent roundings; most
# terms where the running max moved).  The element's difference is then
# ~2**-8.3 of the root-sum-square of its terms / l; each element is allowed
# FWD_P_SHARE (2**-5, ~10 of those RMS) of it on top of one bf16 ulp.
# Dropping one 64-key tile moves O by far more than the whole tolerance
# (chip_smoke.py logs by how much).
FWD_P_SHARE = 2**-5


def fwd_rounding_allowance(q, k, v, q_pos, kv_pos):
    """Per O element, FWD_P_SHARE · sqrt(Σ_j (p_j v_jd)²) / l with p and l
    as ``flash_attention_plain`` computes them: float32 (B, S, Hq, D)."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kv = kv_pos if kv_pos.dim() == 2 else kv_pos[None].expand(B, T)
    vis = (kv[:, None, :] <= q_pos[:, :, None])[:, :, None, None, :]
    s = torch.einsum("bskgd,btkd->bskgt", q.float().reshape(B, S, Hkv, G, D), k.float())
    s = (s / math.sqrt(D)).masked_fill(~vis, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - torch.where(torch.isinf(m), torch.zeros_like(m), m))
    del s
    l = p.sum(dim=-1, keepdim=True)
    rss = torch.einsum("bskgt,btkd->bskgd", p.square_(), v.float().square()).sqrt_()
    return (FWD_P_SHARE * rss / torch.where(l > 0, l, 1.0)).reshape(B, S, Hq, D)


def _bwd_probs(q, k, v, q_pos, kv_pos, g, lse, delta):
    """p = exp(s − L) on visible pairs and ds = p (dO·vᵀ − Dr), float32,
    (B, S, Hkv, G, T): what both backward kernels recompute."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if kv_pos.dim() == 1:
        kv_pos = kv_pos[None, :].expand(B, T)
    vis = (kv_pos[:, None, :] <= q_pos[:, :, None])[:, :, None, None, :]
    s = torch.einsum("bskgd,btkd->bskgt", q.float().reshape(B, S, Hkv, G, D), k.float())
    s = (s * (1.0 / math.sqrt(D))).masked_fill(~vis, float("-inf"))
    rows = lambda x: x.reshape(B, Hkv, G, S).permute(0, 3, 1, 2)[..., None]  # noqa: E731
    p = torch.exp(s - rows(lse))
    dp = torch.einsum("bskgd,btkd->bskgt", g.float().reshape(B, S, Hkv, G, D), v.float())
    return p, p * (dp - rows(delta))


def flash_bwd_dq_plain(q, k, v, q_pos, kv_pos, g, lse, delta):
    """The dq kernel's function: dq = scale · ds·K, ds rounded to the
    operands' dtype first, in q's dtype."""
    B, S, Hq, D = q.shape
    _, ds = _bwd_probs(q, k, v, q_pos, kv_pos, g, lse, delta)
    dq = torch.einsum("bskgt,btkd->bskgd", _rounded(ds, q.dtype), k.float()) * (1.0 / math.sqrt(D))
    return dq.reshape(B, S, Hq, D).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, q_pos, kv_pos, g, lse, delta):
    """The dk/dv kernel's function: dk = scale · dsᵀ·Q and dv = pᵀ·dO, p and
    ds rounded to the operands' dtype first, summed over each kv head's
    query heads, in k's dtype."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    p, ds = _bwd_probs(q, k, v, q_pos, kv_pos, g, lse, delta)
    qf = q.float().reshape(B, S, Hkv, G, D)
    dk = torch.einsum("bskgt,bskgd->btkd", _rounded(ds, q.dtype), qf) * (1.0 / math.sqrt(D))
    dv = torch.einsum("bskgt,bskgd->btkd", _rounded(p, q.dtype),
                      g.float().reshape(B, S, Hkv, G, D))
    return dk.to(k.dtype), dv.to(v.dtype)


def bwd_delta(out, g, g_lse=None):
    """Dr = Σ_d dO·O per row, (B, Hq, S) float32, minus the LSE cotangent
    ``g_lse`` (B, Hq, S) when there is one (∂lse_i/∂s_ij = p_ij folds it into
    the row term)."""
    delta = (g.float() * out.float()).sum(dim=-1).transpose(1, 2)
    if g_lse is not None:
        delta = delta - g_lse.float()
    return delta.contiguous()


def flash_attention_bwd_plain(q, k, v, q_pos, kv_pos, out, lse, g, g_lse=None):
    """The two backward kernels' function in plain PyTorch, float32 inside
    with p and ds rounded to the operands' dtype before the dq, dk and dv
    products: (dq in q's dtype, dk and dv in k's dtype)."""
    delta = bwd_delta(out, g, g_lse)
    dq = flash_bwd_dq_plain(q, k, v, q_pos, kv_pos, g, lse, delta)
    return (dq, *flash_bwd_dkv_plain(q, k, v, q_pos, kv_pos, g, lse, delta))


def _check(q, k, v, q_pos, kv_pos, extra=()):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B,S,Hq,D) and k/v (B,T,Hkv,D): "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hq % Hkv or S < 1 or T < 1:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if q_pos.dtype != torch.int32 or q_pos.shape != (B, S):
        raise ValueError(f"q_pos must be int32 (B, S), got {q_pos.dtype} {tuple(q_pos.shape)}")
    if kv_pos.dtype != torch.int32 or kv_pos.shape not in ((T,), (B, T), (1, T)):
        raise ValueError(f"kv_pos must be int32 (T,) or (B, T), got {kv_pos.dtype} {tuple(kv_pos.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"q/k/v must share a float32 or bfloat16 dtype: {q.dtype}, {k.dtype}, {v.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {_HEAD_DIMS}")
    for name, t, shape, dtype in extra:
        if t.shape != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {tuple(shape)}, got {t.dtype} {tuple(t.shape)}")
    named = (("q", q), ("k", k), ("v", v), ("q_pos", q_pos), ("kv_pos", kv_pos))
    for name, t in named + tuple((e[0], e[1]) for e in extra):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16 and t.is_floating_point():
            raise ValueError(f"{name} must be 16-byte aligned")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention: unsupported device {q.device}")


def _bind(source, name, n_ptrs):
    """The library's C function ``name``: n_ptrs pointers, then the shape
    ints, kv_bstride, scale, dtype and the stream."""
    fn = getattr(load_library(source), name)
    if fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * n_ptrs + [i] * 6 + [ctypes.c_longlong, ctypes.c_float, i, vp]
        fn.restype = ctypes.c_int
    return fn


def _launch(fn, what, ptrs, q, k, kv_pos):
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    kv_bstride = T if kv_pos.dim() == 2 and kv_pos.shape[0] == B and B > 1 else 0
    with torch.cuda.device(q.device):
        err = fn(*(t.data_ptr() for t in ptrs), B, S, T, Hq, Hkv, D, kv_bstride,
                 1.0 / math.sqrt(D), _DTYPES[q.dtype],
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def flash_attention_fwd(q, k, v, q_pos, kv_pos):
    """The forward kernel's wrapper: (out (B, S, Hq, D) in q's dtype,
    lse (B, Hq, S) float32, L_EMPTY where no key is visible).  CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    _check(q, k, v, q_pos, kv_pos)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_pos, kv_pos)
    global launches
    B, S, Hq, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    _launch(_bind(SOURCE, "csm_flash_attention_fwd", 7), "flash attention",
            (q, k, v, q_pos, kv_pos, out, lse), q, k, kv_pos)
    launches += 1
    return out, lse


def _bwd_checks(q, g, lse, delta):
    B, S, Hq, _ = q.shape
    return (("g", g, q.shape, q.dtype), ("lse", lse, (B, Hq, S), torch.float32),
            ("delta", delta, (B, Hq, S), torch.float32))


def flash_attention_bwd_dq(q, k, v, q_pos, kv_pos, g, lse, delta):
    """The dq kernel's wrapper: g = dO (B, S, Hq, D) in q's dtype, lse and
    delta (B, Hq, S) float32 → dq in q's dtype.  CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise."""
    _check(q, k, v, q_pos, kv_pos, _bwd_checks(q, g, lse, delta))
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, q_pos, kv_pos, g, lse, delta)
    global dq_launches
    dq = torch.empty_like(q)
    _launch(_bind(BWD_SOURCE, "csm_flash_attention_bwd_dq", 9), "flash backward dq",
            (q, k, v, q_pos, kv_pos, g, lse, delta, dq), q, k, kv_pos)
    dq_launches += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, q_pos, kv_pos, g, lse, delta):
    """The dk/dv kernel's wrapper → (dk, dv), each (B, T, Hkv, D) in k's
    dtype.  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    _check(q, k, v, q_pos, kv_pos, _bwd_checks(q, g, lse, delta))
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, q_pos, kv_pos, g, lse, delta)
    global dkv_launches
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(_bind(BWD_SOURCE, "csm_flash_attention_bwd_dkv", 10), "flash backward dk/dv",
            (q, k, v, q_pos, kv_pos, g, lse, delta, dk, dv), q, k, kv_pos)
    dkv_launches += 1
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, and the two backward kernels for its gradient
    through the output and the log-sum-exp; an unused output's cotangent
    comes as None."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos):
        ctx.set_materialize_grads(False)
        out, lse = flash_attention_fwd(q, k, v, q_pos, kv_pos)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, out, lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        """dq, dk, dv through the dq kernel, then the dk/dv kernel; autograd
        may hand a non-contiguous g."""
        q, k, v, q_pos, kv_pos, out, lse = ctx.saved_tensors
        g = torch.zeros_like(out) if g is None else g.contiguous()
        delta = bwd_delta(out, g, g_lse)
        dq = flash_attention_bwd_dq(q, k, v, q_pos, kv_pos, g, lse, delta)
        dk, dv = flash_attention_bwd_dkv(q, k, v, q_pos, kv_pos, g, lse, delta)
        return dq, dk, dv, None, None


def flash_gqa_attention_with_lse(q, k, v, q_pos, kv_pos):
    """Flash attention with the per-row log-sum-exp, differentiable in both.

    q (B, S, Hq, D); k/v (B, T, Hkv, D); q_pos (B, S) int32; kv_pos (T,) or
    (B, T) int32 (PAD_POS marks dead slots).  Returns (out (B, S, Hq, D) in
    q's dtype, lse (B, Hq, S) float32, L_EMPTY where no key is visible)."""
    return _FlashAttention.apply(q, k, v, q_pos, kv_pos)


def flash_gqa_attention(q, k, v, q_pos, kv_pos) -> torch.Tensor:
    """Flash attention, output only: equal to ``gqa_attention`` under
    ``causal_mask_from_positions(q_pos, kv_pos)`` wherever a row sees a key,
    and differentiable through the backward kernels."""
    return _FlashAttention.apply(q, k, v, q_pos, kv_pos)[0]
