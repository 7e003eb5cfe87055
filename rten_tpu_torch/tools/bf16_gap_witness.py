"""What sets path (L-bf16)'s tolerance in ``chip_smoke.py``
(``BF16_PATH_LOGIT_TOL``): the card-against-CPU logit gap of GPT-2-small
with int8 weights and the int8 + tail cache under bf16 compute, at the
smoke's batch 64, capacity 128, 8-token prompts and 20 new tokens
(``card_against_cpu`` with logits + argmax), in one process on one card:

* ``kernels``: the path as the smoke runs it (K1, K3 and K4 on the card);
* ``plain``: K1, K3 and K4 replaced on the card by their plain versions,
  the code the CPU runs: the gap that the library arithmetic and the bf16
  roundings make without any hand-written kernel;
* ``f32``: the same path under f32 compute (the int8 + tail path): the gap
  without bf16 activations;
* four planted faults, one at a time and on the card only, each a kernel
  launched with its inputs altered: K1 reads one packed row fewer, K3
  leaves the last window row unflushed, K4 skips the last 64 of K, and K4
  rounds its sums to bf16 before the scales (a fault of one rounding's
  size).

Prints, for each run, the largest logit difference against the CPU over
the rows computed from identical histories, that of the prefill's logits,
and the requests whose tokens part.

    python rten_tpu_torch/tools/bf16_gap_witness.py CHECKOUT

CHECKOUT is the root of a checkout of the repository; its
``chip_smoke.py`` and ``rten_tpu_torch`` are the ones imported, so run
this file by its path, not with ``-m``. Needs one NVIDIA card.
"""

import os
import subprocess
import sys


def main(argv):
    tree = os.path.abspath(argv[0])
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch
    import chip_smoke as cs
    from rten_tpu_torch.generate import kv_cache
    from rten_tpu_torch.kernels import attention as at
    from rten_tpu_torch.kernels import cache as kc
    from rten_tpu_torch.kernels import gemm
    from rten_tpu_torch.models import transformer as tr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs._build.build_all()
    weights = cs.quantize_weights(
        cs.gpt2_model("f32").init_params(0, device="cuda"))
    k1, k3, k4 = (tr.decode_attn_int8_tail, kv_cache.tail_flush_int8,
                  tr.matmul_int8_wo)

    def k1_short(q, kv, scales, lengths, tail, tail_count, **kw):
        if q.is_cuda:
            lengths = lengths - 1
        return k1(q, kv, scales, lengths, tail, tail_count, **kw)

    def k3_short(tail, kv, scales, lengths, t):
        if tail.is_cuda and t > 1:
            return k3(tail, kv, scales, lengths - 1, t - 1)
        return k3(tail, kv, scales, lengths, t)

    def k4_short_k(x, w, scales):
        if x.is_cuda:
            x = x.clone()
            x[:, -64:] = 0
        return k4(x, w, scales)

    def k4_bf16_sums(x, w, scales):
        if not x.is_cuda:
            return k4(x, w, scales)
        sums = k4(x, w, torch.ones_like(scales))
        return sums.to(torch.bfloat16).to(torch.float32) * scales[None, :]

    plain = dict(decode_attn_int8_tail=at.decode_attn_int8_tail_plain,
                 tail_flush_int8=kc.tail_flush_int8_plain,
                 matmul_int8_wo=gemm.matmul_int8_wo_plain)
    runs = (("kernels", "int8_tail_bf16", {}),
            ("plain", "int8_tail_bf16", plain),
            ("f32", "int8_tail", {}),
            ("K1 reads one packed row fewer", "int8_tail_bf16",
             dict(decode_attn_int8_tail=k1_short)),
            ("K3 leaves the last window row unflushed", "int8_tail_bf16",
             dict(tail_flush_int8=k3_short)),
            ("K4 skips the last 64 of K", "int8_tail_bf16",
             dict(matmul_int8_wo=k4_short_k)),
            ("K4 rounds its sums to bf16 before the scales",
             "int8_tail_bf16", dict(matmul_int8_wo=k4_bf16_sums)))
    homes = dict(decode_attn_int8_tail=tr, tail_flush_int8=kv_cache,
                 matmul_int8_wo=tr)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(smi)
    lines = []
    for label, path, swaps in runs:
        saved = {name: getattr(homes[name], name) for name in swaps}
        for name, fn in swaps.items():
            setattr(homes[name], name, fn)
        reading = {}
        try:
            counts = cs.card_against_cpu(
                cs.gpt2_model(path), weights, path, float("inf"),
                max_batch=cs.batch_of("int8_tail_bf16"), fused=False,
                new_tokens=cs.PATHS["int8_tail_bf16"]["requests"][1],
                capacity=128, reading=reading)
        finally:
            for name, fn in saved.items():
                setattr(homes[name], name, fn)
        lines.append(f"{label} ({path}): max logit difference "
                     f"{reading['dev']:.4e}, prefill "
                     f"{reading['prefill_dev']:.4e}, "
                     f"{reading['divergences']} of 64 requests part; "
                     f"max |logit| {reading['scale']:.3f}; launches "
                     f"{cs.nonzero(counts)}")
        print(lines[-1], flush=True)
    print("\n".join(["summary:"] + lines))


if __name__ == "__main__":
    main(sys.argv[1:])
