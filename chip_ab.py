"""Times the port's flash-attention forward and backward kernels of one
checkout at the main-path shapes, on one NVIDIA GPU.

    python3 chip_ab.py <checkout>

To compare two versions on one card, unpack both (``git archive``) into
directories that ``.gitignore`` lists and time them in turns in one
machine session: parent, change, change, parent. The checkout's own
``chip_smoke.py`` gives the inputs and the timer, and its kernels are
built from its own sources into its own ``build/``. Prints one JSON line:
mean ms per call (CUDA events around eager calls through the wrappers)
and the launches by entry point, which show the kernels timed.
"""

import json
import os
import sys


def main() -> None:
    tree = os.path.abspath(sys.argv[1])
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as smoke
    from ray_tpu_torch.ops import flash_attention as fa

    smoke.phase_device()
    libs = [p[:-3] for p in os.listdir("ray_tpu_torch/csrc") if p.endswith(".cu")]
    smoke._kernels.build(sorted(libs))
    row = {"checkout": sys.argv[1]}
    for tag, shape in (("fwd_1b", (2, 16, 8, 2048, 2048, 128)),
                       ("fwd_350m", (8, 8, 8, 2048, 2048, 128))):
        q, k, v = smoke.flash_inputs(*shape, torch.bfloat16, 1)
        row[tag] = smoke.time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=True),
                                 iters=50)
    for tag, shape in (("bwd_350m", (8, 8, 8, 2048, 2048, 128)),
                       ("bwd_1b", (2, 16, 8, 2048, 2048, 128))):
        args = smoke.bwd_inputs(*shape, torch.bfloat16, True, 3)
        row[tag] = smoke.time_ms(lambda: fa.flash_bwd_fused(*args, causal=True), iters=30)
    # the long-context route's two kernels (T=S=16384, 350m width)
    args = smoke.bwd_inputs(1, 8, 8, 16384, 16384, 128, torch.bfloat16, True, 5)
    row["dq_16k"] = smoke.time_ms(lambda: fa.flash_bwd_dq(*args, causal=True), iters=10)
    row["dkv_16k"] = smoke.time_ms(lambda: fa.flash_bwd_dkv(*args, causal=True), iters=10)
    row["launches"] = fa.launch_counts()
    smoke.emit(row)


if __name__ == "__main__":
    main()
