"""K3's (``tail_flush_int8``) device time a step in a traced steady burst
of the int8 + tail path, in a fresh process of one checkout: that
checkout's ``chip_smoke.py`` decode at a full batch (GPT-2-small int8
weights from ``init_params(0)``, batch 256, capacity 512, the 16-token
tail window: one flush of 12 layers every 16 steps) under the profiler,
the kernel found by its CUDA symbol.

    python rten_tpu_torch/tools/flush_trace.py CHECKOUT

CHECKOUT is the root of a checkout of the repository (this one, or the
unpacked ``git archive`` of another commit, so that two commits can be
run in turns on one card); its ``chip_smoke.py`` and ``rten_tpu_torch``
are the ones imported, so run this file by its path, not with ``-m``.
K3's symbol is the decode appends' kernel body (``kvappend::kernel``)
where the checkout's ``csrc/tail_flush_int8.cu`` runs on
``kv_append.cuh``, else the one-warp kernel before it
(``tail_flush_int8_kernel``). Prints the path's burst lines, the traced
step and K3's device time a step. Needs one NVIDIA card.
"""

import os
import sys


def main(argv):
    tree = os.path.abspath(argv[0])
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch
    import chip_smoke as cs

    with open(os.path.join(tree, "rten_tpu_torch", "csrc",
                           "tail_flush_int8.cu")) as f:
        body = '#include "kv_append.cuh"' in f.read()
    symbol = "kvappend::kernel" if body else "tail_flush_int8_kernel"
    path = "int8_tail"
    cs.PATHS[path]["trace_kernel"] = ("K3 (tail_flush_int8)", symbol)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs._build.build_all()
    model = cs.gpt2_model(path)
    params = cs.quantize_weights(model.init_params(0, device="cuda"))
    print(f"checkout {os.path.basename(tree)}: K3 traced as {symbol}",
          flush=True)
    cs.steady_decode(model, params, path, trace=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
