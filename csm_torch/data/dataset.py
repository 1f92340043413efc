"""CSMDataset & batch iteration.

Capability equivalent of the reference ``CSMDataset`` +
``create_dataloader``/``collate_variable_length``
(src/csm/data/training_data.py:227-408): each item tokenizes context
segments + the target segment into the (T, 33) frame format and produces
(T, 32) next-frame audio targets; batches are zero-padded.

The JAX package's dataset, copied (host-side numpy); ``collate`` returns CPU
tensors, which the trainer moves to its device.  As there:
  * padding goes to a small set of static LENGTH BUCKETS (powers-of-two
    style), not to the per-batch max;
  * targets come with an explicit ``target_mask`` (the reference zero-pads
    and lets pad tokens pollute the loss);
  * the loss contract is explicit: ``targets[t]`` is the audio frame at
    input position t+1, masked to the TARGET segment's audio frames
    (including its all-zero EOS frame, so EOS emission is learned).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from csm_torch.data import frames as fr
from csm_torch.data.processor import TrainingExample
from csm_torch.models.config import ModelArgs, csm_1b_args
from csm_torch.training.losses import Batch

LENGTH_BUCKETS = (64, 128, 256, 512, 1024, 2048)


def bucket_for(n: int, buckets=LENGTH_BUCKETS, max_len: int = 2048) -> int:
    for b in buckets:
        if n <= b and b <= max_len:
            return b
    return max_len


class CSMDataset:
    """Tokenized training examples in the CSM frame format.

    Args:
        examples: list of TrainingExample or
            {"context": [TrainingExample...], "target": TrainingExample}.
        text_tokenizer: .encode(str) -> list[int] (BOS/EOS included).
        audio_tokenizer: .encode((T,) float32) -> (K, F) int codes.
    """

    def __init__(
        self,
        examples: Sequence[Union[TrainingExample, Dict]],
        text_tokenizer,
        audio_tokenizer,
        args: Optional[ModelArgs] = None,
        max_seq_len: int = 2048,
    ):
        self.examples = list(examples)
        self.text_tokenizer = text_tokenizer
        self.audio_tokenizer = audio_tokenizer
        self.args = args or csm_1b_args()
        self.max_seq_len = max_seq_len

    def __len__(self) -> int:
        return len(self.examples)

    def _segment(self, ex: TrainingExample):
        ids = self.text_tokenizer.encode(f"[{ex.speaker_id}]{ex.text}")
        codes = self.audio_tokenizer.encode(ex.audio)
        return ids, codes

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        item = self.examples[i]
        if isinstance(item, dict):
            context, target = item.get("context", []), item["target"]
        else:
            context, target = [], item

        K = self.args.audio_num_codebooks
        parts = [fr.segment_frames(self.args, *self._segment(ex)) for ex in context]

        tgt_ids, tgt_codes = self._segment(target)
        tt = fr.text_frames(self.args, tgt_ids)
        ta = fr.audio_frames(self.args, tgt_codes)  # includes EOS frame
        parts += [tt, ta]
        tokens, mask = fr.concat_frames(parts)

        T = tokens.shape[0]
        tgt_audio_start = T - ta[0].shape[0]

        # Truncate from the FRONT, keeping target text + audio
        # (reference: src/csm/data/training_data.py:291-296).
        if T > self.max_seq_len:
            cut = T - self.max_seq_len
            keep_from = min(cut, tgt_audio_start - tt[0].shape[0])
            tokens, mask = tokens[keep_from:], mask[keep_from:]
            T = tokens.shape[0]
            tgt_audio_start -= keep_from
            if T > self.max_seq_len:  # target alone exceeds the window
                tokens, mask = tokens[-self.max_seq_len :], mask[-self.max_seq_len :]
                tgt_audio_start -= T - self.max_seq_len
                T = self.max_seq_len

        targets = np.zeros((T, K), np.int32)
        target_mask = np.zeros((T,), bool)
        lo = max(tgt_audio_start - 1, 0)
        targets[lo : T - 1] = tokens[lo + 1 : T, :K]
        target_mask[lo : T - 1] = True

        return {
            "tokens": tokens,
            "tokens_mask": mask,
            "targets": targets,
            "target_mask": target_mask,
        }


def collate(items: List[Dict[str, np.ndarray]], pad_to: Optional[int] = None) -> Batch:
    """Zero-pad items to a common (bucketed) length → Batch of CPU tensors
    (reference collate: src/csm/data/training_data.py:379-408)."""
    B = len(items)
    T = pad_to or bucket_for(max(it["tokens"].shape[0] for it in items))
    K1 = items[0]["tokens"].shape[1]
    K = items[0]["targets"].shape[1]

    tokens = np.zeros((B, T, K1), np.int32)
    mask = np.zeros((B, T, K1), bool)
    targets = np.zeros((B, T, K), np.int32)
    tmask = np.zeros((B, T), bool)
    for b, it in enumerate(items):
        t = min(it["tokens"].shape[0], T)
        tokens[b, :t] = it["tokens"][:t]
        mask[b, :t] = it["tokens_mask"][:t]
        targets[b, :t] = it["targets"][:t]
        tmask[b, :t] = it["target_mask"][:t]
    return Batch(*map(torch.from_numpy, (tokens, mask, targets, tmask)))


def batch_iterator(
    dataset: CSMDataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = False,
) -> Iterator[Batch]:
    """Length-bucketed batch iterator (host-side; the reference wraps
    torch DataLoader, src/csm/data/training_data.py:361-376)."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    for i in range(0, len(order), batch_size):
        idx = order[i : i + batch_size]
        if drop_last and len(idx) < batch_size:
            return
        yield collate([dataset[int(j)] for j in idx])
