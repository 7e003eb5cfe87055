"""Q1' (``matmul_int4_words_int8``) timed in a fresh process of one
checkout, alone or after the kernel phases that ``chip_smoke.py`` runs
before it: a probe of how what ran earlier in a process moves a kernel's
time.

    python rten_tpu_torch/tools/q1p_after_phases.py CHECKOUT MODE

CHECKOUT is the root of a checkout of the repository (this one, or the
unpacked ``git archive`` of another commit, so that two commits can be
run in turns on one card); its ``chip_smoke.py`` and ``rten_tpu_torch``
are the ones imported, so run this file by its path, not with ``-m``.
MODE: ``alone`` (``check_int4`` only), ``after`` (first the kernel phases
``chip_smoke.py`` runs before it, in its order) or ``after_noprof`` (the
same, with the profiler sessions of K5's and P1's phases, their
one-CUDA-kernel checks, skipped). Prints Q1''s device time a decode step
of path (F), with ``chip_smoke.py``'s timer. Needs one NVIDIA card.
"""

import os
import sys

MODES = ("alone", "after", "after_noprof")


def main(argv):
    tree, mode = os.path.abspath(argv[0]), argv[1]
    if mode not in MODES:
        raise SystemExit(f"mode must be one of {MODES}")
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs._build.build_all()
    timer = cs.Timer()
    real = cs.device_launches

    def launches(fn, *args, **kw):
        return 1.0 if launches.skip else real(fn, *args, **kw)

    launches.skip = False
    cs.device_launches = launches
    quiet = mode == "after_noprof"
    if mode != "alone":
        cs.check_int8_matmul()
        w, s, w_dq = cs._head_weights(768, 50257)
        cs.check_decode_attn(timer)
        cs.check_head_argmax(timer, w, s, w_dq, 50257)
        cs.check_tail_flush(timer)
        cs.check_matmul_wo(timer, w, s, w_dq, 50257)
        launches.skip = quiet
        cs.check_kv_append(timer)
        launches.skip = False
        cs.check_decode_attn_float(timer)
        cs.check_kv_append_int8(timer)
        cs.check_decode_attn_int8(timer)
        launches.skip = quiet
        cs.check_kv_append_paged(timer, quantized=False)
        launches.skip = False
        cs.check_kv_append_paged(timer, quantized=True)
        for attn in ("grouped", "int8", "grid"):
            cs.check_decode_attn_paged(timer, attn)
        del w, s, w_dq
    for r in cs.check_int4(timer):
        if r["name"] == "matmul_int4_words_int8":
            print(f"Q1' {os.path.basename(tree)} {mode}: {r['ms']:.4f}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
