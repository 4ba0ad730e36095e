"""Plain PyTorch versions of the SSD scan kernel: the sequential state-space
recurrence, in the kernel's flattened (BH, S, ...) layout (``ssd_ref``) and
in the model layer's (b, S, H, P) layout with grouped B/C
(``ssd_apply_ref``), and the chunked form the reference trains with
(``ssd_chunked_ref``), whose vjp is the SSD backward.  They compute in
float32 (float64 for float64 inputs)."""
from __future__ import annotations

import torch


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor):
    """x (BH, S, P); dt (BH, S); A (BH,); B/C (BH, S, N), any float dtype.
    Returns (y (BH, S, P), final_state (BH, P, N)), both float32:
    ``S_t = exp(dt_t·A)·S_{t-1} + dt_t·x_t⊗B_t``, ``y_t = S_t·C_t``."""
    bh, s, p = x.shape
    acc = _acc(x.dtype)
    x, dt, A, B, C = (t.to(acc) for t in (x, dt, A, B, C))
    state = torch.zeros((bh, p, B.shape[-1]), dtype=acc, device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * A)[:, None, None]
        upd = torch.einsum("b,bp,bn->bpn", dt[:, t], x[:, t], B[:, t])
        state = state * decay + upd
        ys.append(torch.einsum("bpn,bn->bp", state, C[:, t]))
    y = torch.stack(ys, dim=1) if ys else x.new_zeros((bh, 0, p))
    return y, state


def _per_row_a(A: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """A (H,) shared by the batch, or (b, H) a batch row -> (b, H)."""
    return A.expand(b, h) if A.dim() == 1 else A


def ssd_apply_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor):
    """x (b, S, H, P); dt (b, S, H); A (H,) or (b, H); B/C (b, S, G, N),
    G | H -> (y (b, S, H, P), final_state (b, H, P, N)), float32.
    Flattens (b, H) to rows as the reference's ``ssd_apply`` does: B/C
    repeated per head, A tiled over the batch."""
    b, s, h, p = x.shape
    n = B.shape[3]
    rep = h // B.shape[2]

    def flat(t):  # (b, S, H, ...) -> (b·H, S, ...)
        return t.movedim(2, 1).reshape((b * h, s) + t.shape[3:])

    y, fin = ssd_ref(flat(x), flat(dt[..., None])[..., 0],
                     _per_row_a(A, b, h).reshape(b * h),
                     flat(B.repeat_interleave(rep, dim=2)),
                     flat(C.repeat_interleave(rep, dim=2)))
    return y.reshape(b, h, s, p).movedim(1, 2), fin.reshape(b, h, p, n)


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    B: torch.Tensor, C: torch.Tensor, chunk: int):
    """The chunked state-space-duality form (Mamba2 §6), a port of the
    reference's ``repro/models/layers.py:_ssd_chunked``: x (b, S, H, P);
    dt (b, S, H); A (H,) or (b, H); B/C (b, S, G, N), G | H; S % chunk ==
    0.  Returns (y (b, S, H, P), final_state (b, H, P, N)).  An intra-chunk
    (chunk × chunk) product, each chunk's contribution to its final state,
    and a recurrence over the S/chunk chunks: O(S·chunk) work, what the
    reference differentiates for training."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"S={s} is not a multiple of chunk={chunk}")
    nc, rep = s // chunk, h // g
    acc = _acc(x.dtype)
    xc = x.to(acc).reshape(b, nc, chunk, h, p)
    dtc = dt.to(acc).reshape(b, nc, chunk, h)
    Bc = B.to(acc).repeat_interleave(rep, dim=2).reshape(b, nc, chunk, h, n)
    Cc = C.to(acc).repeat_interleave(rep, dim=2).reshape(b, nc, chunk, h, n)
    a = _per_row_a(A, b, h).to(acc)[:, None, None, :]

    cum = torch.cumsum(dtc * a, dim=2)            # inclusive log decay
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # (b,c,q,q,h)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()
    decay = torch.exp(seg.masked_fill(~tri[None, None, :, :, None],
                                      float("-inf")))
    scores = torch.einsum("bcqhn,bcshn->bcqsh", Cc, Bc) * decay
    y_intra = torch.einsum("bcqsh,bcsh,bcshp->bcqhp", scores, dtc, xc)

    to_end = torch.exp(cum[:, :, -1:, :] - cum)                # (b,c,q,h)
    state_in = torch.einsum("bcsh,bcsh,bcshn,bcshp->bchpn", to_end, dtc,
                            Bc, xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])                  # (b,c,h)
    state = torch.zeros((b, h, p, n), dtype=acc, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = state * chunk_decay[:, c, :, None, None] + state_in[:, c]
    entering = torch.stack(entering, dim=1)                    # (b,c,h,p,n)
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp",
                           Cc * torch.exp(cum)[..., None], entering)
    return (y_intra + y_inter).reshape(b, s, h, p), state
