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
counts each launch in ``flash_row_attention.launches``.  On a CUDA tensor
that the kernel does not take, it raises.  It is forward only: the
gradient of B4, as in the JAX package, is the plain attention's
(:func:`mha_rows`), and the ``"pallas_attn"`` block
(``models/attention.py``, ``_BilinearBlock``) takes it so, a chunk of rows
at a time.  Under grad, with an input that requires a gradient, the
wrapper raises rather than return a result that no gradient reaches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .fused_block import MAX_SCORE_BYTES

# what the kernel is instantiated for: C = 32 * G with G threads a query,
# and H heads with D = C / H lanes each split over the G threads
KERNEL_DIMS = (32, 64, 128, 256)
KERNEL_HEADS = (2, 4, 8)
# dynamic shared memory a block may use on the H100 (227 KB)
MAX_SMEM_BYTES = 232448


def kernel_smem_bytes(N: int, C: int, num_heads: int) -> int:
    """Shared memory of one attention block: the row's keys x (N rows of
    C + 8 bf16, padded against bank conflicts) and one head's v (N x D)."""
    return 2 * N * (C + 8 + C // num_heads)


def bilinear_weights(qkv_kernel: torch.Tensor, num_heads: int):
    """A (H, C, C) f32 with A_h = Wq_h Wk_h^T / sqrt(D), from the qkv kernel
    (C, 3C) as given (the route casts it to the compute dtype first), and
    Wv (C, C) as given."""
    C = qkv_kernel.shape[0]
    H = num_heads
    D = C // H
    wq = qkv_kernel[:, :C].float().reshape(C, H, D).permute(1, 0, 2)     # (H, C, D)
    wk = qkv_kernel[:, C:2 * C].float().reshape(C, H, D).permute(1, 0, 2)
    return torch.einsum("hcd,hed->hce", wq, wk) * D ** -0.5, qkv_kernel[:, 2 * C:]


def mha_rows(rows: torch.Tensor, qkv_kernel: torch.Tensor, proj_kernel: torch.Tensor,
             proj_bias: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The plain multi-head self-attention over rows (R, N, C) -> (R, N, C),
    in the rows' dtype with f32 scores and softmax."""
    dt = rows.dtype
    R, N, C = rows.shape
    H = num_heads
    D = C // H
    qkv = (rows @ qkv_kernel.to(dt)).view(R, N, 3, H, D).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]                          # (R, H, N, D)
    scores = (q * D ** -0.5).float() @ k.float().transpose(-1, -2)
    weights = torch.softmax(scores, dim=-1).to(dt)
    out = (weights @ v).transpose(1, 2).reshape(R, N, C)
    return out @ proj_kernel.to(dt) + proj_bias.to(dt)


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


def _check_cuda(rows: torch.Tensor, weights, num_heads: int) -> None:
    """What the CUDA kernel takes: raise on anything else."""
    name = "flash_row_attention"
    if rows.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {rows.device}")
    if rows.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bfloat16, got {rows.dtype}")
    if rows.dim() != 3 or not rows.is_contiguous() or rows.data_ptr() % 16:
        raise ValueError(f"{name}: rows must be a contiguous, 16-byte aligned (R, N, C) tensor")
    R, N, C = rows.shape
    if C not in KERNEL_DIMS or num_heads not in KERNEL_HEADS:
        raise ValueError(f"{name}: no kernel for C={C}, {num_heads} heads (C in "
                         f"{KERNEL_DIMS}, heads in {KERNEL_HEADS})")
    if kernel_smem_bytes(N, C, num_heads) > MAX_SMEM_BYTES:
        raise ValueError(f"{name}: a row of N={N}, C={C} does not fit the kernel's "
                         f"shared memory ({kernel_smem_bytes(N, C, num_heads)} bytes)")
    if R * N * C >= 2 ** 31:
        raise ValueError(f"{name}: too many tokens for 32-bit counts")
    if [tuple(w.shape) for w in weights] != [(C, 3 * C), (C, C), (C,)]:
        raise ValueError(f"{name}: weights must be qkv (C, 3C), proj (C, C) and bias (C,)")
    if any(w.device != rows.device for w in weights):
        raise ValueError(f"{name}: parameters are not on the rows' device")


def _kernel(rows: torch.Tensor, qkv_kernel: torch.Tensor, proj_kernel: torch.Tensor,
            proj_bias: torch.Tensor, num_heads: int, export: bool = False):
    """One launch of row_attention_forward: ``(out, acc, v, t)``, with v
    (R*N, C) the kernel's bf16(x @ Wv) and, with ``export``, t (R*N, H*C)
    its bf16(x @ A_h) per head (else None)."""
    _check_cuda(rows, (qkv_kernel, proj_kernel, proj_bias), num_heads)
    R, N, C = rows.shape
    dt, dev = rows.dtype, rows.device
    a, wv = bilinear_weights(qkv_kernel, num_heads)
    a, wv, wp = (w.to(dt).contiguous() for w in (a, wv, proj_kernel))
    bias = proj_bias.float().contiguous()
    v = torch.empty((R * N, C), dtype=dt, device=dev)
    acc = torch.empty_like(rows)
    out = torch.empty_like(rows)
    t = torch.empty((R * N, num_heads * C), dtype=dt, device=dev) if export else None
    with torch.cuda.device(dev):
        err = _lib().row_attention_forward(
            rows.data_ptr(), a.data_ptr(), wv.data_ptr(), wp.data_ptr(), bias.data_ptr(),
            v.data_ptr(), acc.data_ptr(), out.data_ptr(), t.data_ptr() if export else None,
            R, N, C, num_heads, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"row_attention_forward failed: CUDA error {err}")
    return out, acc, v, t


def flash_row_attention(rows: torch.Tensor, qkv_kernel: torch.Tensor,
                        proj_kernel: torch.Tensor, proj_bias: torch.Tensor,
                        num_heads: int) -> torch.Tensor:
    """softmax((x Wq)(x Wk)^T / sqrt(D)) (x Wv) Wo + b over rows (R, N, C)
    through B4; kernels as in RowBlockParams.  Forward only."""
    args = (rows, qkv_kernel, proj_kernel, proj_bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise RuntimeError("flash_row_attention has no gradient of its own: train "
                           "through attention_impl='pallas_attn', whose block takes "
                           "the plain attention's VJP")
    if rows.device.type == "cpu":
        return flash_row_attention_reference(*args, num_heads)
    out = _kernel(*args, num_heads)[0]
    flash_row_attention.launches += 1
    return out


flash_row_attention.launches = 0
