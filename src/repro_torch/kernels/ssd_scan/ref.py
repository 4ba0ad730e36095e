"""Plain PyTorch versions of the SSD scan kernel: the sequential state-space
recurrence, in the kernel's flattened (BH, S, ...) layout (``ssd_ref``) and
in the model layer's (b, S, H, P) layout with grouped B/C
(``ssd_apply_ref``)."""
from __future__ import annotations

import torch


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor):
    """x (BH, S, P); dt (BH, S); A (BH,); B/C (BH, S, N), any float dtype.
    Returns (y (BH, S, P), final_state (BH, P, N)), both float32:
    ``S_t = exp(dt_t·A)·S_{t-1} + dt_t·x_t⊗B_t``, ``y_t = S_t·C_t``."""
    bh, s, p = x.shape
    x, dt, A, B, C = (t.float() for t in (x, dt, A, B, C))
    state = torch.zeros((bh, p, B.shape[-1]), dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * A)[:, None, None]
        upd = torch.einsum("b,bp,bn->bpn", dt[:, t], x[:, t], B[:, t])
        state = state * decay + upd
        ys.append(torch.einsum("bpn,bn->bp", state, C[:, t]))
    y = torch.stack(ys, dim=1) if ys else x.new_zeros((bh, 0, p))
    return y, state


def ssd_apply_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor):
    """x (b, S, H, P); dt (b, S, H); A (H,); B/C (b, S, G, N), G | H ->
    (y (b, S, H, P), final_state (b, H, P, N)), float32.  Flattens (b, H) to
    rows as the reference's ``ssd_apply`` does: B/C repeated per head, A
    tiled over the batch."""
    b, s, h, p = x.shape
    n = B.shape[3]
    rep = h // B.shape[2]

    def flat(t):  # (b, S, H, ...) -> (b·H, S, ...)
        return t.movedim(2, 1).reshape((b * h, s) + t.shape[3:])

    y, fin = ssd_ref(flat(x), flat(dt[..., None])[..., 0], A.repeat(b),
                     flat(B.repeat_interleave(rep, dim=2)),
                     flat(C.repeat_interleave(rep, dim=2)))
    return y.reshape(b, h, s, p).movedim(1, 2), fin.reshape(b, h, p, n)
