"""Loss functions."""

import torch


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                          mask=None):
    """Mean token cross-entropy. logits [..., V] (any dtype, upcast to f32),
    labels int [...], optional mask [...] of {0,1}.

    Returns (loss, n_tokens) so callers can re-weight across data shards.
    """
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    label_logits = torch.gather(
        logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - label_logits
    mask = torch.ones_like(nll) if mask is None else mask.float()
    n = torch.clamp(mask.sum(), min=1.0)
    return (nll * mask).sum() / n, n
