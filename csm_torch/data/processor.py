"""Training-data preparation: segmentation & contextual examples.

Capability equivalent of the reference data layer
(src/csm/data/training_data.py):
  * ``TrainingExample`` — one (text, audio, speaker) pair (:16-23);
  * ``CSMDataProcessor`` — loads audio, segments long recordings into
    ~10 s chunks with 2 s overlap, either char-proportionally (:81-114) or
    from a word-alignment JSON ``{"words": [{word, start, end}, ...]}``
    (:116-176); skips segments under 10 chars or 1 s;
  * ``ContextualExampleGenerator`` — sliding-window conversational context
    (:179-224).

All host-side numpy, copied from the JAX package's ``data/processor.py``;
device work (Mimi encode) happens in the dataset.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np

from csm_torch.data.audio import load_audio


@dataclasses.dataclass
class TrainingExample:
    text: str
    audio: np.ndarray  # float32 mono at ``sample_rate``
    speaker_id: int
    metadata: Dict = dataclasses.field(default_factory=dict)


class CSMDataProcessor:
    """Segment (audio file, transcript) pairs into TrainingExamples."""

    def __init__(
        self,
        sample_rate: int = 24_000,
        segment_duration: float = 10.0,
        overlap_duration: float = 2.0,
        min_duration: float = 1.0,
        min_chars: int = 10,
    ):
        self.sample_rate = sample_rate
        self.segment_duration = segment_duration
        self.overlap_duration = overlap_duration
        self.min_duration = min_duration
        self.min_chars = min_chars

    # ---- public API ----

    def prepare_from_audio_file(
        self,
        audio_path: str,
        transcript_path: str,
        speaker_id: int,
        alignment_path: Optional[str] = None,
    ) -> List[TrainingExample]:
        audio = load_audio(audio_path, self.sample_rate)
        with open(transcript_path) as f:
            text = f.read().strip()
        base_meta = {"source_file": os.path.basename(audio_path)}

        if alignment_path and os.path.exists(alignment_path):
            with open(alignment_path) as f:
                alignment = json.load(f)
            segs = self._segment_by_alignment(audio, alignment)
        else:
            segs = self._segment_by_chars(audio, text)

        out = []
        for i, (seg_text, seg_audio) in enumerate(segs):
            if len(seg_text) < self.min_chars:
                continue
            if len(seg_audio) < self.min_duration * self.sample_rate:
                continue
            out.append(
                TrainingExample(
                    text=seg_text,
                    audio=seg_audio,
                    speaker_id=speaker_id,
                    metadata={**base_meta, "segment_index": i},
                )
            )
        return out

    # ---- segmentation strategies ----

    def _segment_by_chars(self, audio: np.ndarray, text: str):
        """Char-proportional segmentation: split the transcript across the
        audio assuming uniform speaking rate, windows of
        ``segment_duration`` with ``overlap_duration`` overlap."""
        sr = self.sample_rate
        total = len(audio) / sr
        if total <= self.segment_duration:
            return [(text, audio)]

        stride = self.segment_duration - self.overlap_duration
        segs = []
        t = 0.0
        while t < total - self.min_duration:
            t_end = min(t + self.segment_duration, total)
            c0 = int(round(len(text) * t / total))
            c1 = int(round(len(text) * t_end / total))
            # snap to word boundaries
            c0 = _snap_left(text, c0)
            c1 = _snap_right(text, c1)
            seg_text = text[c0:c1].strip()
            seg_audio = audio[int(t * sr) : int(t_end * sr)]
            segs.append((seg_text, seg_audio))
            if t_end >= total:
                break
            t += stride
        return segs

    def _segment_by_alignment(self, audio: np.ndarray, alignment: Dict):
        """Word-alignment-driven segmentation: greedily pack words into
        windows up to ``segment_duration`` long, cutting at word ends."""
        words = alignment.get("words", [])
        if not words:
            return []
        sr = self.sample_rate
        segs = []
        cur: List[Dict] = []
        cur_start = float(words[0]["start"])
        for w in words:
            if cur and float(w["end"]) - cur_start > self.segment_duration:
                segs.append(self._emit(audio, cur, cur_start, sr))
                # overlap: restart from words inside the overlap window
                keep_from = float(cur[-1]["end"]) - self.overlap_duration
                cur = [x for x in cur if float(x["start"]) >= keep_from]
                cur_start = float(cur[0]["start"]) if cur else float(w["start"])
            cur.append(w)
        if cur:
            segs.append(self._emit(audio, cur, cur_start, sr))
        return segs

    @staticmethod
    def _emit(audio, words, start, sr):
        end = float(words[-1]["end"])
        text = " ".join(w["word"] for w in words)
        return (text, audio[int(start * sr) : int(end * sr)])


def _snap_left(text: str, i: int) -> int:
    while i > 0 and i < len(text) and not text[i - 1].isspace():
        i -= 1
    return i


def _snap_right(text: str, i: int) -> int:
    while i < len(text) and not text[i].isspace():
        i += 1
    return i


class ContextualExampleGenerator:
    """Sliding-window conversational context
    (reference: src/csm/data/training_data.py:179-224).

    ``create_contextual_examples([e0, e1, e2, ...])`` yields
    ``{"context": [up to max_context_turns previous examples],
       "target": e_i}`` for every turn.
    """

    def __init__(self, max_context_turns: int = 3):
        self.max_context_turns = max_context_turns

    def create_contextual_examples(
        self, conversation: List[TrainingExample]
    ) -> List[Dict]:
        out = []
        for i, target in enumerate(conversation):
            ctx = conversation[max(0, i - self.max_context_turns) : i]
            out.append({"context": list(ctx), "target": target})
        return out

    def create_conversational_examples(
        self, examples: List[TrainingExample]
    ) -> List[Dict]:
        """Like ``create_contextual_examples`` but grouped by source file
        (reference ``--conversational``, src/csm/cli/train_mlx.py:627-669):
        each recording is its own conversation, so a context window never
        spans unrelated recordings.  Grouping key is
        ``metadata["source_file"]`` (set by CSMDataProcessor); examples
        without one are each treated as their own conversation."""
        groups: Dict[object, List[TrainingExample]] = {}
        for i, ex in enumerate(examples):
            key = ex.metadata.get("source_file")
            if key is None:
                key = ("__solo__", i)
            groups.setdefault(key, []).append(ex)
        out: List[Dict] = []
        for conv in groups.values():
            out.extend(self.create_contextual_examples(conv))
        return out
