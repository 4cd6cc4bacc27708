"""The ``sd_unet`` family against the numbers the harness computed before
it was a family (the tree before ``families/`` existed, on the CPU): the
seeded weights, the model FLOPs, the reckoned kernel calls, and the
reference's images and train steps, bit for bit."""

import hashlib
import json

import pytest
import torch

import h100bench_tiny as tiny
from conftest import CHECKOUT
from hb import roofline
from hb.family import seeded_weights

SD_UNET = tiny.family()


def load(path):
    return json.loads((CHECKOUT / path).read_text())


SD15, SDXL = load("h100bench/configs/sd15.json"), load("h100bench/configs/sdxl.json")
CELLS = {"sd15-t2i-dpm50": (SD15, load("h100bench/traffic/t2i-dpm50-512.json")),
         "sdxl-t2i-euler30": (SDXL, load("h100bench/traffic/t2i-euler30-1024.json")),
         "sd15-lcm4-map": (SD15, load("h100bench/traffic/lcm4-map-512.json"))}


def digest(named) -> str:
    """The first 16 hex digits of the sha256 of each (name, tensor)'s name
    and bytes, in order."""
    h = hashlib.sha256()
    for name, t in named:
        h.update(name.encode())
        h.update(t.detach().reshape(-1).contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


@pytest.fixture
def one_thread():
    """One intra-op thread: a float32 sum on the CPU is then done in one
    order, as the pinned digests were."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


WEIGHTS = {
    ("sd", torch.float32): {"unet": "91f0988847846193", "vae": "f33619b56c165233",
                            "text_encoder": "c3f05b5cdd953f76"},
    ("sd", torch.bfloat16): {"unet": "b0933e4f33c56cf1", "vae": "3a88d5e8e09392a0",
                             "text_encoder": "7ff04916f7222d6f"},
    ("xl", torch.float32): {"unet": "aff29ce67f60fed3", "vae": "f33619b56c165233",
                            "text_encoder": "c3f05b5cdd953f76",
                            "text_encoder_2": "1f054f198f0fe41b"},
    ("xl", torch.bfloat16): {"unet": "cf9091a31d54b470", "vae": "3a88d5e8e09392a0",
                             "text_encoder": "7ff04916f7222d6f",
                             "text_encoder_2": "47f9714246b5639c"},
}


@pytest.mark.parametrize("name,dtype", list(WEIGHTS), ids=lambda x: str(x).split(".")[-1])
def test_seeded_weights_are_the_parents(name, dtype):
    cfg = {"sd": tiny.SD, "xl": tiny.XL}[name]
    c = tiny.cell(cfg, tiny.DPM)
    meta = SD_UNET.reference_modules(cfg)
    got = {s: digest(w.items()) for s, w in seeded_weights(c, meta, "cpu", dtype).items()}
    assert got == WEIGHTS[name, dtype]


FLOPS = {
    "sd15-t2i-dpm50": {"text": 26597007360, "unet_eval": 1606546882560,
                       "decode": 2514518933504, "request": 82868460068864},
    "sdxl-t2i-euler30": {"text": 111161610240, "unet_eval": 13522472796160,
                         "decode": 10470392594432, "request": 416255738089472},
    "sd15-lcm4-map": {"text": 13298503680, "unet_eval": 803273441280,
                      "decode": 2514518933504, "request": 5740911202304},
}


@pytest.mark.parametrize("cell", list(FLOPS))
def test_request_flops_at_full_size_are_the_parents(cell):
    """82.868, 416.256 and 5.741 TFLOP a request."""
    assert SD_UNET.request_flops(*CELLS[cell]) == FLOPS[cell]


def test_train_step_flops_at_full_size_are_the_parents():
    """7.165 TFLOP a LoRA train step."""
    assert SD_UNET.train_step_flops(
        SD15, load("h100bench/traffic/lora-train-b4.json")) == 7165243883520


K2_SD15 = {(16384, 512, 512, 1, False): 4, (16384, 512, 512, 1, True): 3,
           (65536, 512, 512, 1, False): 1, (65536, 512, 256, 1, False): 1,
           (65536, 256, 256, 1, True): 3, (65536, 256, 256, 1, False): 2,
           (262144, 256, 256, 1, False): 1, (262144, 256, 128, 1, False): 1,
           (262144, 128, 128, 1, True): 3, (262144, 128, 128, 1, False): 2}
K2_SDXL = {(16384, 512, 512, 1, False): 5, (16384, 512, 512, 1, True): 5,
           (65536, 512, 512, 1, False): 4, (65536, 512, 512, 1, True): 3,
           (262144, 512, 512, 1, False): 1, (262144, 512, 256, 1, False): 1,
           (262144, 256, 256, 1, True): 3, (262144, 256, 256, 1, False): 2,
           (1048576, 256, 256, 1, False): 1, (1048576, 256, 128, 1, False): 1,
           (1048576, 128, 128, 1, True): 3, (1048576, 128, 128, 1, False): 2}
KERNELS = {
    "sd15-t2i-dpm50": ({(2, 8, 4096, 4096, 40): 250}, K2_SD15,
                       0.010856843518705764, 0.002266908926705763),
    "sdxl-t2i-euler30": ({(2, 10, 4096, 4096, 64): 300, (2, 20, 1024, 1024, 64): 1800}, K2_SDXL,
                         0.04559874277856421, 0.00984932844016987),
    "sd15-lcm4-map": ({(1, 8, 4096, 4096, 40): 20}, K2_SD15,
                      0.00043427374074823054, 0.002266908926705763),
}


@pytest.mark.parametrize("cell", list(KERNELS))
def test_reckoned_kernel_calls_and_bounds_are_the_parents(cell):
    """K1 250, 2,100 and 20 calls a request by shape, K2 21, 31 and 21, and
    the seconds of their bounds: the parent's (b, h, s, d) became (b, h,
    s_q, s_kv, d) with s_q = s_kv."""
    k1, k2, k1_s, k2_s = KERNELS[cell]
    calls = SD_UNET.kernel_calls(*CELLS[cell])
    assert calls == {"flash_attention": k1, "conv3x3": k2}
    assert roofline.k1_bound_s(calls["flash_attention"]) == pytest.approx(k1_s, rel=1e-12)
    assert roofline.k2_bound_s(calls["conv3x3"]) == pytest.approx(k2_s, rel=1e-12)


IMAGES = {("dpm", "float32"): "db08bc0499570f57", ("dpm", "fp8"): "6508d3e5f222c196",
          ("euler", "float32"): "1e6a5d9a96b270fc", ("euler", "fp8"): "3969c91bc615103e",
          ("lcm", "float32"): "8044bdc6ed3801cc", ("lcm", "fp8"): "bb86b9bd1966b421"}
TINY = {"dpm": (tiny.SD, tiny.DPM), "euler": (tiny.XL, tiny.EULER),
        "lcm": (tiny.SD, tiny.LCM_MAP)}


@pytest.mark.parametrize("name,precision", list(IMAGES), ids="-".join)
def test_reference_images_are_the_parents_bit_for_bit(name, precision, one_thread):
    """The tiny cells' first two requests as the check and the control
    render them, in float32 and with the products in fp8."""
    c = tiny.cell(*TINY[name])
    d = tiny.driver(c)
    imgs = SD_UNET.reference_outputs(c, [(i, d.request_seed(i)) for i in range(2)], precision)
    assert digest([(str(i), x) for i, x in enumerate(imgs)]) == IMAGES[name, precision]


def test_reference_train_steps_are_the_parents_bit_for_bit(one_thread):
    """The tiny train cell's pool, initial LoRA, and the reference's three
    steps from it: losses, factors after, every step's gradients."""
    c = tiny.cell(tiny.SD, tiny.TRAIN)
    d = tiny.driver(c)
    d.setup()
    assert digest(sorted(d.pool.items())) == "0c47bb476969f0e9"
    assert digest(sorted(d.initial.items())) == "2b215ac7a92ab608"
    ref = SD_UNET.reference_training(c, d.initial, [d.batch(k) for k in range(3)])
    got = digest([(f"loss{i}", torch.tensor(x)) for i, x in enumerate(ref["losses"])]
                 + sorted(ref["factors"].items())
                 + [(f"g{i}.{k}", v) for i, g in enumerate(ref["grads"])
                    for k, v in sorted(g.items())])
    assert got == "1867f2d41c1aebed"
