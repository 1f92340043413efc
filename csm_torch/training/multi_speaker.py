"""Multi-speaker LoRA orchestration.

The counterpart of the JAX package's ``training/multi_speaker.py``: one
adapter per speaker plus an optional shared adapter, round-robin training
by epoch across speakers, per-speaker saving and sample generation, and the
weighted merge of the shared and a speaker's adapter
(``merge_speaker_models``).

Every speaker's trainer holds the SAME frozen base tensors on the card: the
first trainer makes (and, with ``quant_base``, quantizes) the base, the
others are handed it and keep it as it is, so a speaker costs only its
adapter tree and its optimizer state.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

from csm_torch.training import lora as lora_mod
from csm_torch.training.trainer import CSMLoRATrainer, setup_logger


class MultiSpeakerLoRATrainer:
    """Per-speaker LoRA fine-tuning over one shared base."""

    def __init__(
        self,
        speaker_ids: Sequence[int],
        model_path: Optional[str] = None,
        output_dir: str = "./multi_speaker",
        use_shared_adapter: bool = False,
        speaker_overrides: Optional[Dict[int, dict]] = None,
        **lora_kw,
    ):
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.logger = setup_logger(
            "MultiSpeakerLoRATrainer", os.path.join(output_dir, "multi_speaker.log"))
        overrides = speaker_overrides or {}

        # One trainer owns the base params; the others borrow them.
        self.trainers: Dict[int, CSMLoRATrainer] = {}
        base_params = lora_kw.pop("params", None)
        base_args = lora_kw.pop("args", None)
        for sid in speaker_ids:
            kw = dict(lora_kw)
            kw.update(overrides.get(sid, {}))
            t = CSMLoRATrainer(
                model_path=model_path if base_params is None else None,
                output_dir=os.path.join(output_dir, f"speaker_{sid}"),
                args=base_args, params=base_params, **kw,
            )
            base_params, base_args = t.params, t.args
            t.lora_params = t.init_adapters(1000 + sid)  # decorrelated inits
            self.trainers[sid] = t

        self.shared_trainer: Optional[CSMLoRATrainer] = None
        if use_shared_adapter:
            self.shared_trainer = CSMLoRATrainer(
                model_path=None, output_dir=os.path.join(output_dir, "shared"),
                args=base_args, params=base_params, **lora_kw,
            )

    def train(self, datasets: Dict[int, object], val_datasets: Optional[Dict[int, object]] = None,
              epochs: int = 1, batch_size: int = 2, **train_kw) -> Dict[int, float]:
        """Round-robin: each epoch visits every speaker once."""
        val_datasets = val_datasets or {}
        losses: Dict[int, float] = {}
        for t in self.trainers.values():
            if t.state is None:
                t.prepare_optimizer()
        for epoch in range(epochs):
            for sid, trainer in self.trainers.items():
                if sid not in datasets:
                    continue
                self.logger.info(f"epoch {epoch}: training speaker {sid}")
                trainer.epoch = epoch
                losses[sid] = trainer.train(
                    datasets[sid], val_datasets.get(sid), batch_size=batch_size,
                    epochs=epoch + 1,  # run exactly this epoch
                    **train_kw,
                )
        return losses

    def save_speaker_models(self, save_mode: str = "lora") -> Dict[int, list]:
        out = {}
        for sid, t in self.trainers.items():
            out[sid] = t.save_model(os.path.join(self.output_dir, f"speaker_{sid}", "adapter"),
                                    save_mode=save_mode)
        if self.shared_trainer is not None and self.shared_trainer.state is not None:
            out["shared"] = self.shared_trainer.save_model(
                os.path.join(self.output_dir, "shared", "adapter"), save_mode=save_mode)
        return out

    def merge_speaker_models(self, speaker_id: int, shared_weight: float = 0.5) -> dict:
        """The weighted interpolation of the shared and the speaker's
        adapters: an adapter tree for the speaker's LoRAConfig."""
        t = self.trainers[speaker_id]
        speaker_lora = t.state.params if t.state is not None else t.lora_params
        if self.shared_trainer is None or self.shared_trainer.state is None:
            return speaker_lora
        return lora_mod.interpolate_lora([self.shared_trainer.state.params, speaker_lora],
                                         [shared_weight, 1.0 - shared_weight])

    def generate_sample(self, speaker_id: int, text: str, output_path=None, **kw):
        return self.trainers[speaker_id].generate_sample(
            text, speaker_id=speaker_id, output_path=output_path, **kw)
