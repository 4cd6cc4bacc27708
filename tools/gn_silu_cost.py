#!/usr/bin/env python3
"""What the SiLU form costs the fused GroupNorm, on one CUDA card.

    python3 tools/gn_silu_cost.py

Builds the kernels twice from ``sfast_tpu_torch/csrc``: as shipped, where
SiLU takes ``__expf`` and ``__fdividef``, and with
``-DSFAST_GN_SILU_IEEE``, where it takes ``expf`` and an IEEE division.
At each of the UNet's 18 GroupNorm shapes (``chip_smoke.UNET_GN``) it
times the fused GroupNorm from each library by the profiler's kernel rows
(``chip_smoke.device_ms``), in turns shipped, IEEE, IEEE, shipped, and
compares the two outputs.  The last line is one JSON object: each form's
device ms summed over one UNet eval's 61 GroupNorms.
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FORMS = {"__expf": (), "expf": ("-DSFAST_GN_SILU_IEEE",)}


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("gn_silu_cost: torch.cuda.is_available() is false")
    import chip_smoke
    from sfast_tpu_torch.ops.group_norm import group_norm_fused
    from sfast_tpu_torch.runtime import cuda_build

    chip_smoke.log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())
    with ThreadPoolExecutor(len(FORMS)) as pool:
        paths = dict(zip(FORMS, pool.map(cuda_build.build, FORMS.values())))
    libs = {form: cuda_build.load(path) for form, path in paths.items()}

    def with_lib(form, fn):
        cuda_build._lib = libs[form]  # the wrappers launch from this library
        return fn()

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(1)
    per_eval = dict.fromkeys(FORMS, 0.0)
    for hw, c, act, count in chip_smoke.UNET_GN:
        x = (torch.randn((2, hw, hw, c), generator=g, device=dev) + 0.3).to(torch.bfloat16)
        gamma = torch.rand((c,), generator=g, device=dev) + 0.5
        beta = torch.randn((c,), generator=g, device=dev) * 0.2
        eps = 1e-5 if act else 1e-6

        def run():
            return group_norm_fused(x, gamma, beta, groups=32, eps=eps, act=act)

        ys = {form: with_lib(form, run) for form in FORMS}
        _, max_rel, rms = chip_smoke.rel_errors(ys["__expf"], ys["expf"])
        floor = chip_smoke.bound(0, 4 * x.numel())[0]
        ms = {form: [] for form in FORMS}
        for form in ("__expf", "expf", "expf", "__expf"):
            ms[form].append(with_lib(form, lambda: chip_smoke.device_ms(run, floor)))
        mean = {form: sum(t) / len(t) for form, t in ms.items()}
        for form in FORMS:
            per_eval[form] += count * mean[form]
        chip_smoke.log(f"(2, {hw}², {c}) act={act} x{count}: " + ", ".join(
            f"{form} {mean[form] * 1e3:.2f} µs" for form in FORMS)
            + f"; outputs max_rel {max_rel:.2e} rms_rel {rms:.2e}")
    print(json.dumps({"per_eval_ms": per_eval}), flush=True)


if __name__ == "__main__":
    main()
