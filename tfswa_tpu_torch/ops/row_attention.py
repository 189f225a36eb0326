"""Bilinear row attention, B4 (counterpart of
``tfswa_tpu/ops/pallas/row_attention.py`` ``flash_row_attention``).

softmax((x Wq)(x Wk)^T / sqrt(D)) (x Wv) Wo + b over independent rows
(R, N, C), in the TPU kernel's bilinear form: per head
``A_h = Wq_h Wk_h^T / sqrt(D)`` (C, C), ``t = bf16(x @ A_h)`` and the scores
``t . x`` over all C lanes, a standard max-subtracted softmax in f32,
normalised before p is rounded to bf16, and ``acc = sum p v_h`` per head,
then ``bf16(acc) @ Wo + b`` (see ``csrc/row_attention.cu``).

:func:`flash_row_attention` runs the CUDA kernel on a CUDA tensor and the
plain version (:func:`flash_row_attention_reference`) on a CPU tensor, and
counts each launch in ``flash_row_attention.launches`` (bf16 rows,
``csrc/row_attention.cu``, tensor cores) or
``flash_row_attention.launches_f32`` (f32 rows, ``csrc/row_attention_f32.cu``:
the TPU kernel's function with compute_dtype = float32, its scores q_h . k_h
over each head's D channels in f64 on the FP64 tensor cores, p . v f32).
On a CUDA tensor
that the kernels do not take, it raises.  It is forward only: the
gradient of B4, as in the JAX package, is the plain attention's
(:func:`mha_rows`), and the ``"pallas_attn"`` block
(``models/attention.py``, ``_BilinearBlock``) takes it so, a chunk of rows
at a time.  Under grad, with an input that requires a gradient, the
wrapper raises rather than return a result that no gradient reaches.
"""
from __future__ import annotations

import ctypes

import torch

from ..parallel.comm import reduce_from
from . import _build
from .fused_block import (KERNEL_DTYPES, MAX_SCORE_BYTES, MAX_SMEM_BYTES, MAX_WIDTH,
                          WIDTH_ALIGN, _count, _on_stream, prod_width)

# What the kernels take: C a multiple of WIDTH_ALIGN up to MAX_WIDTH and
# any head count that divides it.  bilinear_attn_kernel (csrc/row_attention.cu)
# is instantiated for C in KERNEL_DIMS and H in KERNEL_HEADS (D from 4 to
# 128, the flagship's); every other width and head count runs
# bilinear_attn_any_kernel (t in shared memory, 64 queries a block, the
# head's v in parts).
KERNEL_DIMS = (32, 64, 128, 256)
KERNEL_HEADS = (2, 4, 8)


def f32_attn_plan(C: int, num_heads: int):
    """``(W, VW, KT)`` of the f32 attention (csrc/row_attention_f32.cu
    attn_kernel<W, VW>): ceil(D / 32) parts of VW outputs a head (VW the
    part's share of D rounded up to 4), scores in chunks of W channels (the
    power of two at least VW), KT keys a tile (32 at W = 32, else 64)."""
    D = C // num_heads
    parts = -(-D // 32)
    vw = (-(-D // parts) + 3) // 4 * 4
    w = 4
    while w < vw:
        w *= 2
    return w, vw, (32 if w == 32 else 64)


def kernel_smem_bytes(C: int, num_heads: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Shared memory of the largest attention block.  float32
    (csrc/row_attention_f32.cu, static): attn_kernel<W, VW>'s two key tiles
    of KT keys (``f32_attn_plan``), each k in f64 at W channels (rows padded
    to W + 4, W = 4: none) and the part's v in f32 at VW (padded to 4 mod
    8), or qkv_kernel's two k-slices
    (64 x 20 f32 of x, 16 x 68 f64 of the weights), whichever is larger.  bfloat16 (csrc/row_attention.cu): at
    C in KERNEL_DIMS and H in KERNEL_HEADS (attn_smem_bytes, 8 warps) its
    128 queries' x, two 32-row slices of A_h's columns (64 at a time), and
    two key tiles (128 keys at C <= 64, else 64) each of x (C columns) and
    of the head's v (D, at least 8), rows padded by 8 bf16; otherwise
    (any_smem_bytes) 64 queries' x and t at CP = prod_width(C), the slices
    of A_h, and two key tiles (32 keys at CP >= 384, else 64) of x and of
    VW columns of v (16 up to D = 9, else 64).  Keys stream through the
    tiles, so neither depends on N."""
    D = C // num_heads
    if dtype == torch.float32:
        w, vw, kt = f32_attn_plan(C, num_heads)
        sk, sv = (4 if w == 4 else w + 4), (vw if vw % 8 == 4 else vw + 4)
        return max(2 * kt * (8 * sk + 4 * sv), 2 * (64 * 20 * 4 + 16 * 68 * 8))
    if C in KERNEL_DIMS and num_heads in KERNEL_HEADS:
        vw = max(D, 8)
        keys = 128 if C <= 64 else 64
        return 2 * (128 * (C + 8) + 2 * 32 * (min(C, 64) + 8) + 2 * keys * (C + 8 + vw + 8))
    cp = prod_width(C)
    vw = 16 if D + 7 <= 16 else 64
    keys = 32 if cp >= 384 else 64
    return 2 * (2 * 64 * (cp + 8) + 2 * 32 * (min(cp, 64) + 8) + 2 * keys * (cp + 8 + vw + 8))


def check_shape(R: int, N: int, C: int, num_heads: int,
                dtype: torch.dtype = torch.bfloat16) -> None:
    """The shapes the CUDA kernels of ``dtype`` take: raise ValueError on
    any other."""
    name = "flash_row_attention"
    if C <= 0 or C % WIDTH_ALIGN or C > MAX_WIDTH:
        raise ValueError(f"{name}: no kernel for C={C} (C a multiple of {WIDTH_ALIGN} up to "
                         f"{MAX_WIDTH})")
    if num_heads <= 0 or C % num_heads:
        raise ValueError(f"{name}: no kernel for {num_heads} heads at C={C} (the head count "
                         "divides C)")
    smem = kernel_smem_bytes(C, num_heads, dtype)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: C={C} does not fit the kernel's shared memory "
                         f"({smem} bytes)")
    if R * N * C >= 2 ** 31:
        raise ValueError(f"{name}: too many tokens for 32-bit counts")


def bilinear_weights(qkv_kernel: torch.Tensor, num_heads: int,
                     dtype: torch.dtype = torch.float32):
    """A (H, C, C) in ``dtype`` (f32, or f64 for B4's function in f64) with A_h =
    Wq_h Wk_h^T / sqrt(D), from the qkv kernel (C, 3C) as given (the route
    casts it to the compute dtype first), and Wv (C, C) as given."""
    C = qkv_kernel.shape[0]
    H = num_heads
    D = C // H
    wq = qkv_kernel[:, :C].to(dtype).reshape(C, H, D).permute(1, 0, 2)     # (H, C, D)
    wk = qkv_kernel[:, C:2 * C].to(dtype).reshape(C, H, D).permute(1, 0, 2)
    return torch.einsum("hcd,hed->hce", wq, wk) * D ** -0.5, qkv_kernel[:, 2 * C:]


def qkv_weights_f64(qkv_kernel: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[Wq / sqrt(D) | Wk | Wv] (C, 3C) in f64, from the qkv kernel (C, 3C):
    B4's f32 form computes q_h . k_h = x A_h x^T and v from x @ this."""
    C = qkv_kernel.shape[0]
    w = qkv_kernel.double()
    return torch.cat([w[:, :C] * (C // num_heads) ** -0.5, w[:, C:]], dim=1)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
            part=None) -> torch.Tensor:
    """Inverted dropout with torch ``nn.Dropout``'s semantics (the JAX
    package's ``_dropout``): each element kept with probability 1 - rate
    and scaled by 1 / (1 - rate), in x's dtype.  The keep mask is drawn
    from ``generator``, which lies on x's device.  ``part`` (dim, index,
    parts): ``x`` is piece ``index`` of ``parts`` along ``dim`` of the
    whole tensor (a tensor-parallel shard); the whole mask is drawn and
    that piece of it kept, so that the bits are the whole tensor's."""
    keep = 1.0 - rate
    shape = list(x.shape)
    if part is not None:
        shape[part[0]] *= part[2]
    kept = torch.rand(shape, generator=generator, device=x.device) < keep
    if part is not None:
        n = x.shape[part[0]]
        kept = kept.narrow(part[0], part[1] * n, n)
    return torch.where(kept, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                   mask=None, dropout_rate: float = 0.0, generator=None,
                   tp=None) -> torch.Tensor:
    """Multi-head softmax(q k^T / sqrt(D)) v on (R, N, C) q, k, v -> (R, N, C)
    in q's dtype, the scores and softmax in f32.  ``mask``, if given, is
    additive, (R or 1, 1, N, N) f32, on the scores (query n, key m at
    [.., n, m]).  With ``generator``, dropout at ``dropout_rate`` on the
    weights after their cast to q's dtype (the reference's site); ``tp``
    (the model axis) when these are its rank's heads of the whole block."""
    dt = q.dtype
    R, N, C = q.shape
    H = num_heads
    D = C // H
    qh, kh, vh = (t.reshape(R, N, H, D).transpose(1, 2) for t in (q, k, v))   # (R, H, N, D)
    scores = (qh * D ** -0.5).float() @ kh.float().transpose(-1, -2)
    if mask is not None:
        scores = scores + mask
    weights = torch.softmax(scores, dim=-1).to(dt)
    if dropout_rate > 0.0 and generator is not None:
        weights = dropout(weights, dropout_rate, generator) if tp is None else \
            dropout(weights, dropout_rate, generator, (1, tp.index, tp.size))
    return (weights @ vh).transpose(1, 2).reshape(R, N, C)


def mha_rows(rows: torch.Tensor, qkv_kernel: torch.Tensor, proj_kernel: torch.Tensor,
             proj_bias: torch.Tensor, num_heads: int, mask=None, dropout_rate: float = 0.0,
             generator=None, tp=None) -> torch.Tensor:
    """The plain multi-head self-attention over rows (R, N, C) -> (R, N, C),
    in the rows' dtype with f32 scores and softmax; ``mask``, dropout as in
    :func:`attention_core`.  Under tensor parallelism (``tp``, the model
    axis) the kernels are this rank's shards (the q, k and v columns of
    its ``num_heads`` heads, the matching rows of ``proj_kernel``), and the
    out-projection is summed over the axis, in f32, before the bias."""
    dt = rows.dtype
    C = qkv_kernel.shape[1] // 3
    qkv = rows @ qkv_kernel.to(dt)
    out = attention_core(qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:], num_heads,
                         mask, dropout_rate, generator, tp)
    out = out @ proj_kernel.to(dt)
    if tp is not None:
        out = reduce_from(out.float(), tp).to(dt)
    return out + proj_bias.to(dt)


def flash_row_attention_reference_parts(rows: torch.Tensor, qkv_kernel: torch.Tensor,
                                        proj_kernel: torch.Tensor, proj_bias: torch.Tensor,
                                        num_heads: int, t=None, v=None):
    """Plain PyTorch version of B4, in f32 arithmetic with the TPU kernel's
    rounding to ``rows.dtype``: A and Wv and Wo rounded; v = rnd(x @ Wv);
    per head t = rnd(x @ A_h), s = t . x over all C lanes, p =
    rnd(e / sum e) with e = exp(s - max s), acc[head's lanes] = p @ v_h;
    out = rnd(acc) @ Wo + b.  Returns ``(out, acc)``, both (R, N, C) in
    ``rows.dtype``, acc before the out-projection.  Chunks over rows so
    that its (rows, N, N) planes stay bounded.

    ``t`` (R*N, H*C) and ``v`` (R*N, C), if given, replace the recomputed
    ones: a check on the card passes the kernel's own, since an f32 sum in
    another order flips a bf16 rounding of t now and then, and under a
    peaked softmax that moves the result by far more than the rest of the
    arithmetic."""
    R, N, C = rows.shape
    H = num_heads
    D = C // H
    dt = rows.dtype

    def rnd(x):
        return x.to(dt).float()

    a, wv = bilinear_weights(qkv_kernel, H)
    a, wv, wp = rnd(a), rnd(wv.float()), rnd(proj_kernel.float())
    b = proj_bias.float()
    t_rows = None if t is None else t.view(R, N, H, C)
    v_rows = None if v is None else v.view(R, N, C)
    chunk = max(1, MAX_SCORE_BYTES // (2 * N * N * 4))
    outs, accs = [], []
    for r0 in range(0, R, chunk):
        x = rows[r0:r0 + chunk].float()
        Rc = x.shape[0]
        vv = rnd(x @ wv) if v is None else v_rows[r0:r0 + Rc].float()
        acc = torch.empty_like(x)
        for h in range(H):
            th = rnd(x @ a[h]) if t is None else t_rows[r0:r0 + Rc, :, h].float()
            s = th @ x.transpose(-1, -2)                      # (Rc, N, N)
            e = torch.exp(s - s.amax(dim=-1, keepdim=True))
            p = rnd(e / e.sum(dim=-1, keepdim=True))
            acc[..., h * D:(h + 1) * D] = p @ vv[..., h * D:(h + 1) * D]
        acc = rnd(acc)
        outs.append((acc @ wp + b).to(dt))
        accs.append(acc.to(dt))
    return torch.cat(outs), torch.cat(accs)


def flash_row_attention_reference(rows: torch.Tensor, qkv_kernel: torch.Tensor,
                                  proj_kernel: torch.Tensor, proj_bias: torch.Tensor,
                                  num_heads: int) -> torch.Tensor:
    """The output of :func:`flash_row_attention_reference_parts`."""
    return flash_row_attention_reference_parts(rows, qkv_kernel, proj_kernel, proj_bias,
                                               num_heads)[0]


def _lib() -> ctypes.CDLL:
    lib = _build.load("row_attention")
    fn = lib.row_attention_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _lib_f32() -> ctypes.CDLL:
    lib = _build.load("row_attention_f32")
    fn = lib.row_attention_forward_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check_cuda(rows: torch.Tensor, weights, num_heads: int, pointers: bool = True) -> None:
    """What the CUDA kernel takes: raise on anything else (``pointers=False``:
    but the alignment, which a traced tensor has not)."""
    name = "flash_row_attention"
    if rows.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {rows.device}")
    if rows.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: the kernel takes bfloat16 or float32, got {rows.dtype}")
    if rows.dim() != 3 or not rows.is_contiguous() or (pointers and rows.data_ptr() % 16):
        raise ValueError(f"{name}: rows must be a contiguous, 16-byte aligned (R, N, C) tensor")
    check_shape(*rows.shape, num_heads, rows.dtype)
    C = rows.shape[2]
    if [tuple(w.shape) for w in weights] != [(C, 3 * C), (C, C), (C,)]:
        raise ValueError(f"{name}: weights must be qkv (C, 3C), proj (C, C) and bias (C,)")
    if any(w.device != rows.device for w in weights):
        raise ValueError(f"{name}: parameters are not on the rows' device")


def _kernel(rows: torch.Tensor, qkv_kernel: torch.Tensor, proj_kernel: torch.Tensor,
            proj_bias: torch.Tensor, num_heads: int, export: bool = False):
    """One launch of row_attention_forward (bf16 rows) or
    row_attention_forward_f32 (f32 rows): ``(out, acc, v, t)``, with v
    (R*N, C) the kernel's x @ Wv in the rows' dtype and, with ``export``
    (else None), bf16 rows' t (R*N, H*C), x @ A_h per head, or f32 rows'
    q|k (R*N, 2C) in f64, x @ [Wq / sqrt(D) | Wk]."""
    _check_cuda(rows, (qkv_kernel, proj_kernel, proj_bias), num_heads)
    R, N, C = rows.shape
    dt, dev = rows.dtype, rows.device
    if dt == torch.float32:
        return _kernel_f32(rows, qkv_weights_f64(qkv_kernel, num_heads), proj_kernel.float(),
                           proj_bias.float(), num_heads, export)
    a, wv = bilinear_weights(qkv_kernel, num_heads)
    a, wv, wp = (w.to(dt).contiguous() for w in (a, wv, proj_kernel))
    bias = proj_bias.float().contiguous()
    v = torch.empty((R * N, C), dtype=dt, device=dev)
    acc = torch.empty_like(rows)
    out = torch.empty_like(rows)
    t = torch.empty((R * N, num_heads * C), dtype=dt, device=dev) if export else None
    err = _on_stream(dev, _lib().row_attention_forward,
                     rows.data_ptr(), a.data_ptr(), wv.data_ptr(), wp.data_ptr(),
                     bias.data_ptr(), v.data_ptr(), acc.data_ptr(), out.data_ptr(),
                     t.data_ptr() if export else None, R, N, C, num_heads)
    if err != 0:
        raise RuntimeError(f"row_attention_forward failed: CUDA error {err}")
    return out, acc, v, t


def _kernel_f32(rows: torch.Tensor, wqkv: torch.Tensor, wp: torch.Tensor, bias: torch.Tensor,
                num_heads: int, export: bool):
    """One launch of row_attention_forward_f32 on checked f32 rows, ``wqkv``
    (C, 3C) f64 (:func:`qkv_weights_f64`); q|k (R*N, 2C) f64 is a scratch,
    or with ``export`` returned."""
    R, N, C = rows.shape
    dev = rows.device
    wqkv, wp, bias = (w.contiguous() for w in (wqkv, wp, bias))
    v = torch.empty((R * N, C), dtype=torch.float32, device=dev)
    acc = torch.empty_like(rows)
    out = torch.empty_like(rows)
    qk = torch.empty((R * N, 2 * C), dtype=torch.float64, device=dev)
    err = _on_stream(dev, _lib_f32().row_attention_forward_f32,
                     rows.data_ptr(), wqkv.data_ptr(), wp.data_ptr(), bias.data_ptr(),
                     v.data_ptr(), acc.data_ptr(), out.data_ptr(), qk.data_ptr(),
                     R, N, C, num_heads)
    if err != 0:
        raise RuntimeError(f"row_attention_forward_f32 failed: CUDA error {err}")
    return out, acc, v, qk if export else None


def flash_row_attention(rows: torch.Tensor, qkv_kernel: torch.Tensor,
                        proj_kernel: torch.Tensor, proj_bias: torch.Tensor,
                        num_heads: int) -> torch.Tensor:
    """softmax((x Wq)(x Wk)^T / sqrt(D)) (x Wv) Wo + b over rows (R, N, C)
    through B4, by the custom op ``tfswa::flash_row_attention``;
    kernels as in RowBlockParams.  Forward only."""
    args = (rows, qkv_kernel, proj_kernel, proj_bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise RuntimeError("flash_row_attention has no gradient of its own: train "
                           "through attention_impl='pallas_attn', whose block takes "
                           "the plain attention's VJP")
    if rows.device.type != "cpu":     # before the op (the launch checks the alignment)
        _check_cuda(rows, args[1:], num_heads, pointers=False)
    from .custom_ops import flash_row_attention as op

    return op(*args, num_heads)


def flash_row_attention_run(rows: torch.Tensor, qkv_kernel: torch.Tensor,
                            proj_kernel: torch.Tensor, proj_bias: torch.Tensor,
                            num_heads: int) -> torch.Tensor:
    """B4 with no autograd check: the plain version on a CPU tensor, the
    kernel (counted) on a CUDA one; what ``tfswa::flash_row_attention``
    runs."""
    if rows.device.type == "cpu":
        return flash_row_attention_reference(rows, qkv_kernel, proj_kernel, proj_bias,
                                             num_heads)
    out = _kernel(rows, qkv_kernel, proj_kernel, proj_bias, num_heads)[0]
    _count(flash_row_attention, rows.dtype)
    return out


flash_row_attention.launches = 0
flash_row_attention.launches_f32 = 0
