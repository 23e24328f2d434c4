"""Model facade: the entry points the serving engine and the trainer call.

PyTorch counterpart of ``repro/models/model.py`` for the dense and vlm
families, the MoE family (every layer MoE, or the llama4 interleave of
dense and MoE layers), the SSM and hybrid families
(``models/transformer.py``) and the audio family (``models/encdec.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import Device
from repro_torch.core.policy import QuantPolicy, quantize_params
from repro_torch.core.quantization import QuantizedTensor
from repro_torch.models import encdec, transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    @property
    def _family(self):
        """The module of the config's family: ``encdec`` for audio,
        ``transformer`` for every other."""
        return encdec if self.cfg.family == "audio" else transformer

    def init(self, seed: int = 0, device: Device = None,
             hold: Device = None):
        """The seeded tree, drawn on ``device`` and held on ``hold`` (the
        same device by default; ``transformer.draw_params``)."""
        return self._family.init_params(self.cfg, seed, device=device,
                                        hold=hold)

    def loss(self, params, batch, mesh=None, specs=None, batch_axes=None):
        """The mean next-token cross-entropy of ``batch`` (``labels`` with
        ``tokens``, a vlm frontend's ``embeds`` or the audio family's
        ``frames`` and ``tokens``): the reference's ``lm_loss``, a 0-d f32
        tensor differentiable in every float leaf of ``params``.  On a
        train ``mesh`` (``launch/steps.py``'s ``jit_train_step``) the
        rank's shards of ``specs`` (the train-mode parameter specs) and its
        rows, split over ``batch_axes``, give its part of the global
        batch's mean (``transformer.train_view``)."""
        return self._family.lm_loss(params, self.cfg, batch, mesh=mesh,
                                    specs=specs, batch_axes=batch_axes)

    def init_meta(self):
        """The tree ``init`` draws, on the meta device (shapes and dtypes
        only): the template a checkpoint restores into."""
        return transformer.meta_params(self.cfg, self._family._param_tree)

    def init_quantized(self, seed: int = 0,
                       policy: Optional[QuantPolicy] = None,
                       device: Device = None, hold: Device = None):
        """``quantize(init(seed), policy)``, fused decode operands
        included (none for the audio family), bit for bit, without ever
        holding the float tree: each weight is quantized as it is drawn
        (``transformer.draw_params``), on ``device``, and held on
        ``hold``."""
        return self._family.init_quantized(self.cfg, seed, policy,
                                           device=device, hold=hold)

    def quantize(self, params, policy: Optional[QuantPolicy] = None,
                 fuse_decode: bool = True):
        """Post-training quantization (the paper's section 3.2 flow), plus
        the fused decode GEMV operands (wqkv / w13 / wo_f) when
        ``fuse_decode``: 4 weight GEMVs per decode layer instead of 7.  The
        audio family's tree gets none, as in the reference."""
        qp = quantize_params(params, policy or QuantPolicy())
        if fuse_decode and self.cfg.family != "audio":
            qp = transformer.fuse_decode_weights(qp, self.cfg)
        return qp

    @property
    def supports_paged_cache(self) -> bool:
        """Whether the family has the paged pool: the families whose cache
        is one stacked attention bank.  The llama4 interleave (two banks)
        and the SSM, hybrid and audio families keep the dense per-slot
        cache (the reference's ``init_paged_cache`` is None for them; here
        it raises)."""
        return transformer.supports_paged_cache(self.cfg)

    def init_cache(self, batch: int, max_seq: int, device: Device = None):
        return self._family.init_cache(self.cfg, batch, max_seq,
                                       device=device)

    def prefill(self, params, batch, max_seq: Optional[int] = None,
                mesh=None, cache_specs=None):
        """``mesh`` / ``cache_specs``: one rank of a mesh, its rows and its
        part of the dense cache (``transformer.prefill``)."""
        return self._family.prefill(params, self.cfg, batch, max_seq=max_seq,
                                    mesh=mesh, cache_specs=cache_specs)

    def init_paged_cache(self, batch: int, *, block_size: int = 64,
                         n_blocks: int, max_blocks_per_seq: int,
                         device: Device = None, mesh=None):
        return transformer.init_paged_cache(
            self.cfg, batch, block_size=block_size, n_blocks=n_blocks,
            max_blocks_per_seq=max_blocks_per_seq, device=device, mesh=mesh)

    def decode_step(self, params, cache, tokens, positions=None, mesh=None,
                    cache_specs=None):
        """``mesh`` serves on one rank of a mesh: the paged pool's KV
        heads, or the dense cache's part under ``cache_specs``
        (``transformer.decode_step``)."""
        return self._family.decode_step(params, self.cfg, cache, tokens,
                                        positions, mesh=mesh,
                                        cache_specs=cache_specs)

    def prefill_chunk(self, params, tokens, cache, slot, offset):
        return transformer.prefill_chunk(params, self.cfg, tokens, cache,
                                         slot, offset)

    def prefill_chunk_batch(self, params, tokens, cache, slots, offs,
                            page_table=None, chunk_lens=None, mesh=None):
        return transformer.prefill_chunk_batch(
            params, self.cfg, tokens, cache, slots, offs,
            page_table=page_table, chunk_lens=chunk_lens, mesh=mesh)

    def prefill_compile_count(self, mesh=None) -> int:
        """Distinct chunk-step shapes so far on meshes of ``mesh``'s shape
        (none: off a mesh): one per (pool key, mesh shape)."""
        return transformer.prefill_chunk_compiles(self.cfg, mesh=mesh)

    def verify_chunk_batch(self, params, tokens, cache, slots, offs,
                           page_table=None, chunk_lens=None, mesh=None):
        return transformer.verify_chunk_batch(
            params, self.cfg, tokens, cache, slots, offs,
            page_table=page_table, chunk_lens=chunk_lens, mesh=mesh)

    def verify_compile_count(self, mesh=None) -> int:
        return transformer.verify_chunk_compiles(self.cfg, mesh=mesh)


def build_model(cfg: ModelConfig) -> Model:
    transformer.check_family(cfg)
    return Model(cfg=cfg)


def count_params(params: Any) -> int:
    """Number of parameters in a tree; a quantized leaf counts its
    unpacked elements, as the reference's ``count_params`` does."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, QuantizedTensor):
        return math.prod(params.q.shape[:-1]) * params.orig_dim
    return math.prod(params.shape)


def params_to(params: Any, device: Device):
    """Move a parameter tree (tensors and QuantizedTensors) to ``device``."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    return params.to(device)
