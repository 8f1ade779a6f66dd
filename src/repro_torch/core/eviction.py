"""SnapKV-style token eviction (paper §5.2 / Table 8 compatibility; port
of ``repro/core/eviction.py``).

Selects the prompt tokens that receive the most attention from an
observation window at the end of the prompt, keeps those plus the window,
and drops the rest — composable with any key codec (the kept keys are
quantized as usual). Like the JAX package's, no engine calls it yet.
"""
from __future__ import annotations

import torch


def snapkv_scores(q_obs: torch.Tensor, k: torch.Tensor,
                  scale: float | None = None,
                  kernel: int = 5) -> torch.Tensor:
    """Accumulated attention from the observation queries to every key.

    q_obs: (B, H, W, d) last-window queries; k: (B, Hkv, T, d). Returns
    (B, Hkv, T) importance scores, max-pooled over ``kernel`` neighbours
    along T (SnapKV keeps local context clusters)."""
    b, h, w, d = q_obs.shape
    hkv = k.shape[1]
    scale = d ** -0.5 if scale is None else scale
    q5 = (q_obs * scale).reshape(b, hkv, h // hkv, w, d).float()
    s = torch.einsum("bhqwd,bhtd->bhqwt", q5, k.float())
    # the observation window attends to every prompt token
    imp = torch.softmax(s, dim=-1).sum(dim=(2, 3))          # (B, Hkv, T)
    pooled = imp
    for off in range(1, kernel // 2 + 1):
        pooled = torch.maximum(pooled, torch.roll(imp, off, dims=-1))
        pooled = torch.maximum(pooled, torch.roll(imp, -off, dims=-1))
    return pooled


def snapkv_select(q_obs: torch.Tensor, k: torch.Tensor, budget: int,
                  obs_window: int) -> torch.Tensor:
    """Boolean keep-mask (B, Hkv, T): the top-(budget - obs_window) scored
    prompt tokens plus the observation window itself."""
    b, hkv, t, _ = k.shape
    scores = snapkv_scores(q_obs, k)
    scores[:, :, t - obs_window:] = float("inf")            # always kept
    # max-pooling makes plateaus of equal scores: break ties toward the
    # lower index, as ``jax.lax.top_k`` does (a stable descending sort)
    idx = torch.sort(scores, dim=-1, descending=True,
                     stable=True).indices[..., :min(budget, t)]
    mask = torch.zeros((b, hkv, t), dtype=torch.bool, device=k.device)
    return mask.scatter_(-1, idx, True)
