#!/usr/bin/env python3
"""Device time of SD1.5 512² text2img images under the default
configuration, from the checkout at ROOT, on one CUDA card.

    python3 tools/profile_image.py ROOT

It imports ROOT's own ``sfast_tpu_torch`` and ``chip_smoke.py``, builds
the pipeline as that ``chip_smoke.py`` does (full width, seeded random
weights, 50 DPM++ steps, CFG 7.5), runs one image to warm up and then
profiles three with that script's ``profile_image`` (device ms per image,
the device's idle share, CUDA kernels per image).  To compare two commits
on one card, unpack the parent with ``git archive`` into a directory that
``.gitignore`` lists and run this in turns, parent, change, change,
parent, in one call.
"""

import os
import subprocess
import sys

IMAGES = 3


def main():
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_image: torch.cuda.is_available() is false")
    import chip_smoke

    chip_smoke.log(f"checkout {root}: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    pipe = chip_smoke.build_pipeline(torch, dev)
    prompt_ids = torch.randint(0, 49408, (1, 77), generator=torch.Generator().manual_seed(1))

    def run():
        return pipe(prompt_ids=prompt_ids, height=512, width=512,
                    num_inference_steps=chip_smoke.STEPS, guidance_scale=7.5, seed=4)

    run()
    for i in range(IMAGES):
        chip_smoke.profile_image(torch, run, f"{os.path.basename(root)} {i}")


if __name__ == "__main__":
    main()
