"""Paged attention over the interleaved KV pool (port of
kubeai_tpu/ops/paged_attention.py).

Replaces the library Pallas kernel
``jax.experimental.pallas.ops.tpu.ragged_paged_attention``, which
``kubeai_tpu/ops/paged_attention.py::paged_attention_ragged`` calls, with
the hand-written CUDA kernel ``csrc/paged_attention.cu``. KV lives as
[P, page, 2*Kv, h] pages with K at even and V at odd head indices; a
block table maps each slot's positions onto pages; each slot's S queries
(1 for decode, a bucket or chunk for prefill) sit at positions
kv_len-S .. kv_len-1 and attend causally, reading pages in place.

Bound on the H100: memory for decode (B=8, kv_len 512: ~16.8 MB per
layer call, ~5 us at 3.35 TB/s), the tensor-core rate for 1024-token
chunks. The kernel shares the flash kernel's tile core with keys found
through the page table; its source says what the design does about it.

``paged_attention_ragged`` launches the kernel for CUDA tensors and runs
the plain version for CPU tensors; there is no fallback between them.
"""

from __future__ import annotations

import torch

from kubeai_tpu_torch.ops import _build
from kubeai_tpu_torch.ops.attention import attention

_SIG = {
    "paged_attention_launch": [_build.PTR] * 5
    + [_build.INT] * 8 + [_build.FLOAT, _build.FLOAT, _build.PTR],
}


def _no_quant(k_scale, v_scale):
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "quantized KV pools are not ported yet (ROADMAP queue 1, item 8)"
        )


def paged_attention_plain(q, kv_pages, page_table, kv_lengths, scale=None, softcap=0.0):
    """The plain PyTorch version (the JAX package's ``_cpu_twin``): gather
    the table's pages into a contiguous view and run masked attention with
    queries at positions kv_len - S + s. kv_len is clamped to the table
    span first (a finished slot's decode overrun)."""
    B, S, H, h = q.shape
    max_pages = page_table.shape[1]
    page = kv_pages.shape[1]
    Kv = kv_pages.shape[2] // 2
    skv = max_pages * page
    kv_lens = torch.clamp(kv_lengths.to(torch.int64), max=skv)
    gathered = kv_pages[page_table.long()]  # [B, mp, page, 2Kv, h]
    k_att = gathered[..., 0::2, :].reshape(B, skv, Kv, h)
    v_att = gathered[..., 1::2, :].reshape(B, skv, Kv, h)
    pos_q = kv_lens[:, None] - S + torch.arange(S, device=q.device)[None, :]
    mask = torch.arange(skv, device=q.device)[None, None, :] <= pos_q[:, :, None]
    return attention(q, k_att, v_att, mask, scale=scale, softcap=softcap)


def launch_paged_kernel(lib, fn: str, what: str, q, kv_pages, page_table, kv_lengths,
                        scale, softcap):
    """Shared argument checks and launch for the two paged kernels (the
    ragged one here and the dedicated decode one)."""
    B, S, H, h = q.shape
    P, page, two_kv, h2 = kv_pages.shape
    Kv = two_kv // 2
    if h2 != h or two_kv % 2 or H % Kv or page_table.dim() != 2 or page_table.shape[0] != B:
        raise ValueError(
            f"{what}: bad shapes q{tuple(q.shape)} pool{tuple(kv_pages.shape)} "
            f"table{tuple(page_table.shape)}"
        )
    if kv_lengths.shape != (B,):
        raise ValueError(f"{what}: kv_lengths must be [B], got {tuple(kv_lengths.shape)}")
    lens = kv_lengths.to(torch.int32).contiguous()
    dtype = _build.check_cuda_inputs(
        what, h, {"q": q, "kv_pages": kv_pages},
        {"page_table": page_table, "kv_lengths": lens},
    )
    out = torch.empty_like(q)
    err = getattr(lib, fn)(
        q.data_ptr(), kv_pages.data_ptr(), page_table.data_ptr(), lens.data_ptr(),
        out.data_ptr(), B, S, H, Kv, h, page, page_table.shape[1], dtype,
        float(scale), float(softcap), _build.stream_of(q),
    )
    _build.check(err, what)
    return out


def paged_attention_ragged(
    q: torch.Tensor,  # [B, S, H, h] the slots' newest S queries
    kv_pages: torch.Tensor,  # [P, page, 2*Kv, h] (K even, V odd)
    page_table: torch.Tensor,  # [B, max_pages] int32
    kv_lengths: torch.Tensor,  # [B] valid keys INCLUDING the S new tokens
    scale: float | None = None,
    softcap: float = 0.0,
    k_scale: float | None = None,
    v_scale: float | None = None,
) -> torch.Tensor:
    """Returns the [B, S, H, h] attention output."""
    _no_quant(k_scale, v_scale)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return paged_attention_plain(q, kv_pages, page_table, kv_lengths, scale, softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_ragged: unsupported device {q.device}")
    lib = _build.load("paged_attention", _SIG)
    out = launch_paged_kernel(
        lib, "paged_attention_launch", "paged_attention_ragged",
        q, kv_pages, page_table, kv_lengths, scale, softcap,
    )
    paged_attention_ragged.launches += 1
    return out


paged_attention_ragged.launches = 0
