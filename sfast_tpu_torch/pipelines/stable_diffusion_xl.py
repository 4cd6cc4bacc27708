"""SDXL text2img, img2img and inpainting: two text encoders and
micro-conditioning.

Counterpart of ``sfast_tpu/pipelines/stable_diffusion_xl.py``, after
diffusers' ``StableDiffusionXLPipeline``: the context is the penultimate
hidden states of both encoders side by side (768 + 1280 = 2048 wide), and
the pooled projection of the second encoder with the six micro-
conditioning ids (``original_size``, ``crops_coords_top_left``,
``target_size``) feeds the UNet's ``text_time`` addition embedding.
Without a negative prompt the uncond branch is zero embeddings
(diffusers' ``force_zeros_for_empty_prompt``, JAX ``:386-392``).  At a
guidance scale ≤ 1, or with an LCM-distilled UNet, there is no uncond
branch.

The initial latents, img2img and inpainting, the step noise and both
loops are the base pipeline's (``_generate``), with the added conditioning
an input of the UNet's graph and of the fused loop's.  JAX's
single-dispatch ``_call_fused_full`` is three graphs here, as in the base
pipeline: the encoders (one graph each, keyed by their output mode), the
loop and the decode.
"""

from typing import List, Optional, Union

import torch

from sfast_tpu_torch.pipelines.stable_diffusion import PipelineOutput, StableDiffusionPipeline


class StableDiffusionXLPipeline(StableDiffusionPipeline):
    def __init__(
        self,
        unet,
        vae,
        text_encoder,
        text_encoder_2,
        scheduler,
        *,
        vae_encode=None,
        tokenizer=None,
        tokenizer_2=None,
        device=None,
        dtype: torch.dtype = torch.bfloat16,
    ):
        super().__init__(unet, vae, text_encoder, scheduler, vae_encode=vae_encode,
                         tokenizer=tokenizer, device=device, dtype=dtype)
        self.text_encoder_2 = text_encoder_2
        self.tokenizer_2 = tokenizer_2

    def _submodels(self):
        return (*super()._submodels(), self.text_encoder_2)

    def _ids_for_encoder_2(self, prompt, prompt_ids) -> torch.Tensor:
        """Token ids for the second encoder (OpenCLIP ViT-bigG), JAX
        ``:46-96``.  diffusers' ``tokenizer_2`` shares the vocabulary and
        merges of ``tokenizer`` and pads with ``"!"`` (id 0) instead of EOS.

        Prompt strings go through ``tokenizer_2``, derived from
        ``tokenizer`` by ``with_pad_token("!")`` when none is attached:
        exact, with transformers' quirk that the pad token splits out of
        the text ("hey!!!" ends in three pad ids).  Ids alone keep
        everything up to the first EOS and pad after it, which is exact for
        a prompt without a literal "!"; rows without an EOS stay as they
        are."""
        if prompt is not None and self.tokenizer_2 is None and (
                self.tokenizer is not None and hasattr(self.tokenizer, "with_pad_token")):
            try:
                self.tokenizer_2 = self.tokenizer.with_pad_token("!")
            except KeyError:  # a vocabulary without "!"
                pass
        if prompt is not None and self.tokenizer_2 is not None:
            if isinstance(prompt, str):
                prompt = [prompt]
            enc = self.tokenizer_2(prompt, padding="max_length",
                                   max_length=self.tokenizer_2.model_max_length,
                                   truncation=True, return_tensors="pt")
            return self._to_device(enc.input_ids).long()
        eos = self.text_encoder_2.config.eos_token_id
        pad = self.tokenizer_2.pad_token_id if self.tokenizer_2 is not None else 0
        ids = self._to_device(prompt_ids).long()
        is_eos = ids == eos
        first_eos = is_eos.int().argmax(dim=-1)
        after = torch.arange(ids.shape[-1], device=ids.device)[None, :] > first_eos[:, None]
        return torch.where(after & is_eos.any(dim=-1, keepdim=True),
                           torch.full_like(ids, pad), ids)

    def _time_ids(self, original_size, crops, target_size, b: int, use_cfg: bool = True):
        """The (rows, 6) f32 micro-conditioning ids on the device, cached by
        value; 2B rows with CFG, B without."""
        rows = 2 * b if use_cfg else b
        key = ("time_ids", tuple(original_size), tuple(crops), tuple(target_size), rows)
        t = self._dev_scalars.get(key)
        if t is None:
            row = [list(original_size) + list(crops) + list(target_size)]
            t = self._dev_scalars[key] = torch.tensor(
                row, dtype=torch.float32, device=self.device).repeat(rows, 1)
        return t

    def encode_prompt_xl(self, prompt_ids, prompt_ids_2):
        """(context (B, 77, D1 + D2), pooled (B, projection_dim)): both
        encoders' penultimate hidden states side by side, and the second
        encoder's projected pooled output."""
        h1 = self.text_encoder(prompt_ids, output="penultimate")
        h2, pooled = self.text_encoder_2(prompt_ids_2, output="penultimate_pooled")
        return torch.cat([h1, h2], dim=-1), pooled

    @torch.inference_mode()
    def __call__(
        self,
        prompt: Optional[Union[str, List[str]]] = None,
        *,
        prompt_ids=None,
        prompt_ids_2=None,
        negative_prompt_ids=None,
        negative_prompt_ids_2=None,
        height: int = 1024,
        width: int = 1024,
        num_inference_steps: int = 50,
        guidance_scale: float = 5.0,
        seed: int = 0,
        latents: Optional[torch.Tensor] = None,
        image=None,
        strength: float = 0.8,
        mask_image=None,
        original_size=None,
        crops_coords_top_left=(0, 0),
        target_size=None,
        output_type: str = "np",  # 'np' | 'pil' | 'pt' (uint8) | 'float' | 'latent'
        callback_on_step_end=None,
    ) -> PipelineOutput:
        """``callback_on_step_end`` and ``output_type`` as the base
        pipeline's, whose ``map`` and ``warmup`` serve SDXL too."""
        self._sched_guard()
        if prompt_ids is None:
            prompt_ids = self.tokenize(prompt)
        if prompt_ids_2 is None:
            prompt_ids_2 = self._ids_for_encoder_2(prompt, prompt_ids)
        if negative_prompt_ids is not None and negative_prompt_ids_2 is None:
            negative_prompt_ids_2 = self._ids_for_encoder_2(None, negative_prompt_ids)
        zero_uncond = negative_prompt_ids is None and negative_prompt_ids_2 is None
        ids, neg, real_b = self._prompt_batch(None, prompt_ids, negative_prompt_ids)
        ids_2, neg_2, _ = self._prompt_batch(None, prompt_ids_2, negative_prompt_ids_2)
        use_cfg = self._use_cfg(guidance_scale)

        cond, pooled_c = self.encode_prompt_xl(ids, ids_2)
        if not use_cfg:
            context, pooled = cond, pooled_c
        else:
            if zero_uncond:
                uncond, pooled_u = torch.zeros_like(cond), torch.zeros_like(pooled_c)
            else:
                if neg is None:
                    neg = self._empty_prompt_ids(ids)
                uncond, pooled_u = self.encode_prompt_xl(neg, neg_2)
            context = torch.cat([uncond, cond])
            pooled = torch.cat([pooled_u, pooled_c])
        time_ids = self._time_ids(original_size or (height, width), crops_coords_top_left,
                                  target_size or (height, width), ids.shape[0], use_cfg)
        added = {"text_embeds": pooled, "time_ids": time_ids}
        return self._generate(
            context, added, use_cfg, real_b, height=height, width=width,
            num_inference_steps=num_inference_steps, guidance_scale=guidance_scale, seed=seed,
            latents=latents, image=image, strength=strength, mask_image=mask_image,
            output_type=output_type, callback_on_step_end=callback_on_step_end)
