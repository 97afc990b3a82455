"""Ulysses sequence parallelism: all-to-all head resharding.

Mirrors ray_tpu/ops/ulysses.py. Each rank holds T/sp rows of q, k and v
with every head; one all-to-all over sp trades them for every row of
H/sp heads, the rank attends the whole sequence on those heads with
``ops.attention.attention`` (on the card: the flash kernels), and the
inverse all-to-all trades back. Differentiable: the exchange's backward
is the inverse exchange. Complement to ``ring_attention``, which keeps
the sequence split and moves k/v blocks instead.

Layout: q [B, T/sp, Hq, D], k/v [B, T/sp, Hkv, D] on each rank.
"""

from __future__ import annotations

from ray_tpu_torch.collective.mesh_ops import mesh_all_to_all
from ray_tpu_torch.ops.attention import attention
from ray_tpu_torch.parallel.mesh import current_mesh


def ulysses_attention(q, k, v, *, causal: bool = True, axis: str = "sp",
                      mesh=None, use_flash: bool | None = None):
    """This rank's rows of attention over the whole sequence, from its rows
    of q, k and v (``mesh`` defaults to the ambient one). With ``axis``
    of size 1, or no mesh, it is ``attention`` itself. Raises unless sp
    divides the heads."""
    if mesh is None:
        mesh = current_mesh()
    names = mesh.mesh_dim_names if mesh is not None else ()
    sp = mesh.size(names.index(axis)) if axis in names else 1
    if sp == 1:
        return attention(q, k, v, causal=causal, use_flash=use_flash)
    for n_heads in (q.shape[2], k.shape[2]):
        if n_heads % sp:
            raise ValueError(f"heads={n_heads} not divisible by {axis}={sp}")

    def fwd(x):  # [B, T/sp, H, D] -> [B, T, H/sp, D]
        return mesh_all_to_all(x, mesh, axis, split_axis=2, concat_axis=1)

    o = attention(fwd(q), fwd(k), fwd(v), causal=causal, use_flash=use_flash)
    return mesh_all_to_all(o, mesh, axis, split_axis=1, concat_axis=2)
