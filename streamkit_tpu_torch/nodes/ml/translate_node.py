# SPDX-License-Identifier: Apache-2.0
"""Translation node: Transcription/Text → translated Text.

Port of ``streamkit_tpu/nodes/ml/translate_node.py``. Parity target:
``plugin::native::nllb`` (``plugins/native/nllb/src/lib.rs:21-70``,
CTranslate2 NLLB-200): FLORES-200 language codes, shared model cache,
Transcription or Text input. The model (:mod:`streamkit_tpu_torch.models.nllb`)
runs on the device the node was registered with (``register_nodes(device=)``).
"""

from __future__ import annotations

import asyncio
import os
from typing import List, Optional

import numpy as np
import torch

from ...core import (
    ChannelClosed,
    ConfigurationError,
    InputPin,
    NodeContext,
    NodeStatsTracker,
    OutputPin,
    Packet,
    PacketType,
    ProcessorNode,
    ResourceKey,
    TelemetryEmitter,
    parse_config_optional,
)
from ...core.state import NodeState, StopReason
from ...device import resolve_device
from ...models.nllb import (
    NllbConfig,
    nllb_beam_translate,
    nllb_config_from_hf,
    nllb_greedy_cached,
    nllb_init_params,
    nllb_params_from_hf,
)
from ._text_batching import BucketedGreedy

__all__ = ["TranslateNode", "RANDOM_INIT_CONFIG"]

# the model of a node without a checkpoint: the reference node's own tiny
# configuration, drawn from seed 0 (mechanics-only mode)
RANDOM_INIT_CONFIG = NllbConfig(
    vocab_size=512, d_model=64, encoder_layers=2, decoder_layers=2,
    heads=4, ffn_dim=128, max_positions=256,
)


class _ByteTokenizer:
    """Offline fallback: ids = utf-8 bytes + 4 (mechanics-only mode)."""

    pad_token_id = 1

    def encode(self, text: str) -> List[int]:
        return [b + 4 for b in text.encode()][:120] + [2]

    def decode_ids(self, ids) -> str:
        return bytes(
            min(255, max(0, int(i) - 4)) for i in ids if int(i) > 4
        ).decode("utf-8", "replace")

    def lang_token(self, code: str) -> int:
        return 3


class TranslateNode(ProcessorNode):
    """NLLB translation (``plugin::native::nllb``)."""

    KIND = "plugin::native::nllb"

    def __init__(self, params: Optional[dict], device=None) -> None:
        cfg = parse_config_optional(
            params,
            {
                "model_path": None,
                "model_dir": None,  # reference param name
                "source_lang": "eng_Latn",
                "target_lang": "spa_Latn",
                "source_language": None,  # reference aliases
                "target_language": None,
                "max_length": None,
                "beam_size": 1,  # 1 = greedy; >1 = beam search (models/seq2seq.py)
                "max_tokens": 128,
                "allow_random_init": True,
                "device": None,  # accepted for reference-yaml compat
                "compute_type": None,
                "num_threads": None,
                "dtype": "float32",
            },
        )
        self.device = resolve_device(device)
        self.model_path = cfg["model_path"] or cfg["model_dir"]
        self.source_lang = cfg["source_language"] or cfg["source_lang"]
        self.target_lang = cfg["target_language"] or cfg["target_lang"]
        self.max_tokens = int(cfg["max_length"] or cfg["max_tokens"])
        self.beam_size = int(cfg["beam_size"])
        if not 1 <= self.beam_size <= 8:
            raise ConfigurationError("plugin::native::nllb: beam_size must be 1-8")
        self.allow_random_init = bool(cfg["allow_random_init"])
        self.dtype = torch.bfloat16 if cfg["dtype"] == "bfloat16" else torch.float32

    def input_pins(self) -> List[InputPin]:
        return [InputPin("in", [PacketType.text(), PacketType.transcription()])]

    def output_pins(self) -> List[OutputPin]:
        return [OutputPin("out", PacketType.text())]

    async def _load(self, ctx: NodeContext):
        async def loader():
            loop = asyncio.get_running_loop()

            def build():
                if self.model_path and os.path.isdir(self.model_path):
                    import transformers

                    hf_cfg = transformers.AutoConfig.from_pretrained(self.model_path)
                    model = transformers.AutoModelForSeq2SeqLM.from_pretrained(self.model_path)
                    sd = {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
                    cfg = nllb_config_from_hf(hf_cfg)
                    params = nllb_params_from_hf(sd, cfg, self.dtype, self.device)
                    tok = transformers.AutoTokenizer.from_pretrained(self.model_path)

                    class _HFTok:
                        pad_token_id = tok.pad_token_id

                        def encode(self, text):
                            return tok(text).input_ids

                        def decode_ids(self, ids):
                            return tok.decode([int(i) for i in ids], skip_special_tokens=True)

                        def lang_token(self, code):
                            return tok.convert_tokens_to_ids(code)

                    return cfg, params, _HFTok()
                if not self.allow_random_init:
                    raise ConfigurationError(f"model not found: {self.model_path}")
                cfg = RANDOM_INIT_CONFIG
                return cfg, nllb_init_params(cfg, 0, self.dtype, self.device), _ByteTokenizer()

            return await loop.run_in_executor(None, build)

        key = ResourceKey.from_params(
            "nllb", {"path": self.model_path, "dtype": str(self.dtype), "device": str(self.device)}
        )
        if ctx.resources is not None:
            return await ctx.resources.get_or_create(key, loader)
        return await loader()

    async def run(self, ctx: NodeContext) -> None:
        stats = NodeStatsTracker(ctx.node_name, ctx.stats_tx)
        telemetry = TelemetryEmitter(ctx.node_name, ctx.telemetry_tx)
        cfg, params, tok = await self._load(ctx)
        ctx.emit_state(NodeState.running())
        loop = asyncio.get_running_loop()
        target_token = tok.lang_token(self.target_lang)

        # cached greedy (or beam) decode on pow-2 source buckets; with an
        # engine batcher, texts from ALL sessions sharing the model coalesce
        # per bucket, and per-row target-language tokens ride the batch, so
        # sessions translating into different languages share device calls
        max_tok = self.max_tokens
        pad_id = cfg.pad_token_id
        beam = self.beam_size
        if beam > 1:
            decode = lambda src_b, tgt_b: nllb_beam_translate(  # noqa: E731
                params, cfg, src_b, tgt_b, max_tokens=max_tok, beam=beam
            )
        else:
            decode = lambda src_b, tgt_b: nllb_greedy_cached(  # noqa: E731
                params, cfg, src_b, tgt_b, max_tokens=max_tok
            )
        bg = BucketedGreedy(
            f"nllb:{id(params)}:{max_tok}:b{beam}", cfg.max_positions, pad_id, decode, device=self.device
        )
        tgt = np.asarray(target_token, np.int32)

        def _strip(toks: np.ndarray, n: int) -> str:
            return tok.decode_ids(
                [i for i in toks[:n] if i not in (cfg.eos_token_id, pad_id)]
            )

        def translate_sync(text: str) -> str:
            return _strip(*bg.run_single(tok.encode(text), tgt))

        async def translate_batched(text: str) -> str:
            return _strip(*(await bg.run_batched(ctx.batcher, tok.encode(text), tgt)))

        try:
            while True:
                pkt = await ctx.recv_with_cancellation("in")
                if pkt is None:
                    break
                stats.packet_received()
                text = pkt.text if pkt.text is not None else (
                    pkt.transcription.text if pkt.transcription else None
                )
                if not text:
                    stats.packet_discarded()
                    continue
                if ctx.batcher is not None:
                    translated = await translate_batched(text)
                else:
                    translated = await loop.run_in_executor(None, translate_sync, text)
                telemetry.emit(
                    "translate.result",
                    {"source": text[:120], "target": translated[:120], "lang": self.target_lang},
                )
                await ctx.output.send("out", Packet.new_text(translated, pkt.metadata))
                stats.packet_sent()
        except ChannelClosed:
            ctx.emit_state(NodeState.stopped(StopReason.OUTPUT_CLOSED))
            stats.flush()
            return
        stats.flush()
        ctx.emit_state(NodeState.stopped(StopReason.INPUT_CLOSED))
