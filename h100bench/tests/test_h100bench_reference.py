"""The plain reference against the port on the CPU at tiny sizes, with the
same weights: a UNet eval, a decode, both CLIP encoders, the samplers
through whole pipelines, and the LoRA train step."""

import json

import numpy as np
import pytest
import torch

import h100bench_tiny as tiny
from conftest import CHECKOUT
from families.sd_unet_lib import prompts
from hb.weights import make_weights

SD_UNET = tiny.family()


def loaded(cfg, seed=1234):
    meta = SD_UNET.reference_modules(cfg)
    w = {s: make_weights(m, seed + i, "cpu", torch.float32) for i, (s, m) in
         enumerate(meta.items())}
    port = SD_UNET.port_modules(cfg, w, "cpu")
    for s, m in meta.items():
        m.load_state_dict(w[s], strict=True, assign=True)
    return meta, port


@pytest.mark.parametrize("cfg", [tiny.SD, tiny.XL], ids=["sd", "xl"])
def test_models_against_the_port(cfg):
    ref, port = loaded(cfg)
    torch.manual_seed(0)
    b = 2
    x, t = torch.randn(b, 4, 8, 8), torch.tensor(500.0)
    ctx = torch.randn(b, 77, cfg["unet"]["cross_attention_dim"])
    added = None
    if "text_encoder_2" in cfg:
        added = {"text_embeds": torch.randn(b, 32), "time_ids": torch.rand(b, 6) * 1024}
    r = ref["unet"](x, t, ctx, added)
    p = port["unet"](x.permute(0, 2, 3, 1), t, ctx,
                     added_cond_kwargs=added).permute(0, 3, 1, 2)
    assert (r - p).abs().max() <= 1e-4 * r.abs().max()
    z = torch.randn(1, 4, 8, 8)
    r = ref["vae"].decode(z)
    p = port["vae"].decode(z.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    assert (r - p).abs().max() <= 1e-4 * r.abs().max()
    ids = torch.from_numpy(prompts.prompt_ids(5, 0))
    hidden, _ = ref["text_encoder"](ids)
    out = cfg["text_encoder"]["output"]
    want = hidden[-1] if out == "last" else hidden[-2]
    assert torch.allclose(port["text_encoder"](ids, output=out), want, atol=1e-4)
    if "text_encoder_2" in cfg:
        ids2 = torch.from_numpy(prompts.ids_for_encoder_2(ids.numpy()))
        hidden, pooled = ref["text_encoder_2"](ids2)
        h, p = port["text_encoder_2"](ids2, output="penultimate_pooled")
        assert torch.allclose(h, hidden[-2], atol=1e-4)
        assert torch.allclose(p, pooled, atol=1e-4)


def test_state_dict_names_at_full_size():
    """Every published name of the reference is the port's, at the cells'
    full sizes (the shapes of the meta modules)."""
    for name in ("sd15", "sdxl"):
        cfg = json.loads((CHECKOUT / f"h100bench/configs/{name}.json").read_text())
        from families.sd_unet_lib.port import port_configs

        ref = SD_UNET.reference_modules(cfg)
        confs = port_configs(cfg)
        from sfast_tpu_torch.models import AutoencoderKL, CLIPTextModel, UNet2DConditionModel
        classes = {"unet": UNet2DConditionModel, "vae": AutoencoderKL,
                   "text_encoder": CLIPTextModel, "text_encoder_2": CLIPTextModel}
        for slot, m in ref.items():
            with torch.device("meta"):
                port = classes[slot](confs[slot], device="meta")
            want = {k: tuple(v.shape) for k, v in m.state_dict().items()}
            assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == want, slot


@pytest.mark.parametrize("cfg,traffic", [(tiny.SD, tiny.DPM), (tiny.XL, tiny.EULER),
                                         (tiny.SD, tiny.LCM_MAP)], ids=["dpm", "euler", "lcm"])
def test_pipelines_against_the_reference(cfg, traffic):
    """The port's float32 images of a window against the reference's: within
    the uint8 rounding."""
    d = tiny.driver(tiny.cell(cfg, traffic))
    win = d.window(d.setup())
    d.free()
    assert win.done >= 1
    r = d.check()
    assert r["image_mean_levels"] < 0.3 and r["image_max_levels"] <= 0.51


def test_train_step_against_the_reference():
    d = tiny.driver(tiny.cell(tiny.SD, tiny.TRAIN))
    win = d.window(d.setup())
    d.free()
    assert win.done >= 1 and all(np.isfinite(d.losses))
    r = d.check()
    assert r["loss_gap"] < 1e-5 and r["grad_gap"] < 1e-4 and r["change_gap"] < 1e-4
    assert d.late["k"] == win.done + 3 and r["late_change_gap"] < 1e-4


def test_the_reference_resumes_adamw_from_a_state():
    """Three steps from a fresh AdamW are two steps, then one from the state
    they left (in ``program.adam_state``'s form)."""
    from families.sd_unet_lib.training import train

    c = tiny.cell(tiny.SD, tiny.TRAIN)
    d = tiny.driver(c)
    d.setup()
    batches = [d.batch(k) for k in range(3)]
    unet, base, ac = SD_UNET.reference_trainer(c)
    lr = tiny.TRAIN["learning_rate"]
    tree = {}
    for name, t in d.initial.items():
        mod, k = name.rsplit(".", 1)
        tree.setdefault(mod, {})[k] = t
    whole = train(unet, base, tree, batches, ac, lr)
    # AdamW over two steps, written out, gives the state the third starts from
    two = train(unet, base, tree, batches[:2], ac, lr)
    g1, g2 = two["grads"]
    state = {k: {"exp_avg": 0.1 * (0.9 * g1[k] + g2[k]),
                 "exp_avg_sq": 0.001 * (0.999 * g1[k] ** 2 + g2[k] ** 2), "step": 2}
             for k in g1}
    moved = {}
    for name, t in two["factors"].items():
        mod, k = name.rsplit(".", 1)
        moved.setdefault(mod, {})[k] = t
    third = train(unet, base, moved, batches[2:], ac, lr, state=state)
    for k, v in whole["factors"].items():
        assert torch.allclose(third["factors"][k], v, rtol=1e-5, atol=1e-9), k
    assert third["losses"][0] == pytest.approx(whole["losses"][2], rel=1e-6)
