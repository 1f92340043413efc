"""Audio watermarker (SilentCipher-equivalent): encode, decode, verify.

The counterpart of the JAX package's ``watermarking/watermarker.py``:
  * a 5-byte message → 2-bit symbols (+1, 0-terminated) → one-hot, tiled
    over the STFT frames;
  * encode: power-normalise to the VCTK average energy, STFT, carrier
    features ⊕ carrier×32 ⊕ message embed×32 → carrier decoder → an
    SDR-scaled additive perturbation with frame-level normalisation →
    iSTFT with the original phase → the original power;
  * decode: an optional phase-shift grid search (step 10 over one hop),
    per-frame argmax, per-slot mode and confidence, 2-bit → bytes;
  * ``watermark()``/``verify()`` resample to the 44.1 kHz model rate and
    back.

Precision: the CNNs and the STFT run in IEEE float32 (``float32_math``:
``fp32_precision = "ieee"`` for cuDNN's and oneDNN's convolutions and
matmuls alike), set inside each call and restored after it, so the
watermark does not depend on what the process set before (PyTorch's default
for float32 convolutions on the card is TF32, and
``torch.set_float32_matmul_precision`` reaches the CPU's oneDNN kernels,
which then round float32 operands to TF32 or bf16 where the CPU has them).  The encoder writes the
watermark with the input's phase; where the input is near silent in an
STFT bin (pure tones), that phase is ``atan2`` of rounding noise, and two
float32 implementations then part there far more than where the input
has a noise floor.

Memory: the phase-shift search decodes its shifts (52 at the defaults) in
chunks of as many shifts as ``DECODE_BUDGET_BYTES`` holds, from a count of
the message decoder's activations at the clip's length.  Each shift's
logits are computed independently, so the chunking computes the same
function (on the card cuDNN may pick another algorithm for another chunk
size, which rounds otherwise).
The JAX package decodes all shifts as one batch, which at 10 s of audio
wants tens of GB.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from csm_torch.data import audio as audio_io
from csm_torch.utils.device import resolve_device
from csm_torch.watermarking import model as wm
from csm_torch.watermarking.stft import float32_math, istft, stft

# Public watermark key (reference: src/csm/watermarking/__init__.py:5).
CSM_1B_GH_WATERMARK = [212, 211, 146, 56, 201]

AVERAGE_ENERGY_VCTK = 0.002837200844477648
MODEL_SR = 44_100
# activations of the message decoder's widest layer held at once per shift
# (a gated conv's input, conv and gate), with one more for cuDNN's
# workspace and the STFT
_LIVE_ACTIVATIONS = 4
DECODE_BUDGET_BYTES = 8 << 30


def bytes_to_symbols(message: Sequence[int]) -> np.ndarray:
    """5 bytes → 20 2-bit symbols."""
    bits = "".join(f"{b:08b}" for b in message)
    return np.array([int(bits[i * 2: i * 2 + 2], 2) for i in range(len(bits) // 2)], np.int32)


def symbols_to_bytes(symbols: Sequence[int]) -> List[int]:
    bits = "".join(f"{int(s):02b}" for s in symbols)
    return [int(bits[i * 8: i * 8 + 8], 2) for i in range(len(bits) // 8)]


def tile_message(symbols: np.ndarray, message_dim: int, n_frames: int) -> np.ndarray:
    """(L-1,) symbols → (message_dim, n_frames) one-hot tiling with the
    0 terminator."""
    index = np.concatenate([symbols + 1, [0]])
    one_hot = np.eye(message_dim, dtype=np.float32)[index]  # (L, D)
    reps = int(np.ceil(n_frames / one_hot.shape[0]))
    return np.tile(one_hot.T, (1, reps))[:, :n_frames]


class Watermarker:
    """Watermarker over a parameter tree on ``device``.

    The 44.1 kHz SilentCipher contract: n_fft 1024, hop 512, message band
    512 bins, message_dim 5 (4 symbols + stop), message_len 21 (20 payload
    symbols = 5 bytes).  ``params`` None draws random weights from seed 0.
    """

    def __init__(
        self,
        params: Optional[dict] = None,
        n_fft: int = 1024,
        hop: int = 512,
        message_band_size: int = 512,
        message_dim: int = 5,
        message_len: int = 21,
        sample_rate: int = MODEL_SR,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            params = wm.init_watermark_params(gen, message_dim, message_band_size, n_fft,
                                              device=self.device)
        self.params = wm.place_params(params, self.device)
        self.n_fft, self.hop = n_fft, hop
        self.message_band_size = message_band_size
        self.message_dim = message_dim
        self.message_len = message_len
        self.sample_rate = sample_rate

    # ---- encode ----

    @torch.inference_mode()
    def _encode(self, y: torch.Tensor, msg_tiled: torch.Tensor, message_sdr: float) -> torch.Tensor:
        p, n_fft, hop = self.params, self.n_fft, self.hop
        with float32_math():
            norm = torch.sqrt(AVERAGE_ENERGY_VCTK / torch.mean(y * y).clamp_min(1e-12))
            mag, phase = stft((y * norm)[None], n_fft, hop)  # (1, F, N)
            carrier = mag[:, None]  # (1, 1, F, N)
            merged = torch.cat([
                wm.encoder_apply(p["enc_c"], carrier),
                carrier.expand(-1, 32, -1, -1),
                wm.transform_message(p["enc_c"], msg_tiled[None, None], n_fft).expand(-1, 32, -1, -1),
            ], dim=1)  # (1, 96, F, N)
            delta = wm.carrier_decoder_apply(p["dec_c"], merged, message_sdr,
                                             self.message_band_size)
            # frame-level normalisation
            delta = delta * torch.sqrt(torch.mean(carrier * carrier, dim=2, keepdim=True))
            recon = torch.abs(delta + carrier)[:, 0]
            return istft(recon, phase, y.shape[0], n_fft, hop)[0] / norm

    def encode_wav(self, audio: np.ndarray, sample_rate: int, message: Sequence[int],
                   message_sdr: float = 36.0) -> np.ndarray:
        """Watermark ``audio`` with a 5-byte message (default SDR 36 dB)."""
        y = np.asarray(audio, np.float32).reshape(-1)
        orig_len = len(y)
        if sample_rate != self.sample_rate:
            y = audio_io.resample(y, sample_rate, self.sample_rate)
        if float(np.mean(y ** 2)) == 0.0:
            return np.asarray(audio, np.float32)  # silence: left as it is

        symbols = bytes_to_symbols(message)
        if len(symbols) != self.message_len - 1:
            raise ValueError(f"a message of {len(message)} bytes does not fill "
                             f"{self.message_len - 1} symbols")
        tiled = tile_message(symbols, self.message_dim, self._n_frames(len(y)))
        out = self._encode(torch.from_numpy(y).to(self.device),
                           torch.from_numpy(tiled).to(self.device), float(message_sdr))
        out = out.cpu().numpy()
        if sample_rate != self.sample_rate:
            out = audio_io.resample(out, self.sample_rate, sample_rate)[:orig_len]
        return out

    def _n_frames(self, T: int) -> int:
        T_pad = T + (self.n_fft - T % self.n_fft) + self.n_fft  # tail + centre pad
        return 1 + (T_pad - self.n_fft) // self.hop

    # ---- decode ----

    def shifts_per_chunk(self, num_samples: int) -> int:
        """Shifts of ``num_samples`` each that one chunk of the phase-shift
        search decodes within ``DECODE_BUDGET_BYTES``."""
        width = max(g.w.shape[0] for g in self.params["dec_m"]["layers"])
        per_shift = (_LIVE_ACTIVATIONS * width * self.message_band_size
                     * self._n_frames(num_samples) * 4)
        return max(1, DECODE_BUDGET_BYTES // per_shift)

    @torch.inference_mode()
    def _decode_frames(self, params: dict, y_shifts: torch.Tensor) -> torch.Tensor:
        """(S, L) power-normalised shifted audio → (S, message_dim, N)
        per-frame symbol logits, ``shifts_per_chunk`` shifts at a time."""
        chunk = self.shifts_per_chunk(y_shifts.shape[1])
        outs = []
        with float32_math():
            for y in y_shifts.split(chunk):
                mag = stft(y, self.n_fft, self.hop)[0][:, None]
                outs.append(wm.msg_decoder_apply(params["dec_m"], mag, self.message_band_size)[:, 0])
        return torch.cat(outs)

    def decode_wav(self, audio: np.ndarray, sample_rate: int,
                   phase_shift_decoding: bool = True, shift_step: int = 10) -> dict:
        """Recover the message.  The phase-shift grid (0..hop in steps of
        ``shift_step``) goes to ``_decode_frames`` as one (S, L) batch."""
        y = np.asarray(audio, np.float32).reshape(-1)
        if sample_rate != self.sample_rate:
            y = audio_io.resample(y, sample_rate, self.sample_rate)
        power = float(np.mean(y ** 2))
        if power == 0.0:
            return {"messages": [], "confidences": [], "status": False}
        y = (y * np.sqrt(AVERAGE_ENERGY_VCTK / power)).astype(np.float32)

        shifts = list(range(0, self.hop, shift_step)) if phase_shift_decoding else [0]
        L = len(y) - max(shifts)
        yd = torch.from_numpy(np.ascontiguousarray(y)).to(self.device)
        batch = torch.stack([yd[s: s + L] for s in shifts])
        logits = torch.as_tensor(self._decode_frames(self.params, batch))
        pred = logits.argmax(dim=1).cpu().numpy()  # (S, N)
        return self._read_message(pred)

    def _read_message(self, pred: np.ndarray) -> dict:
        """(S, N) per-frame symbols of each shift → the best shift's
        message: per-slot mode, accuracy, terminator rotation, bytes."""
        best = None
        for p in pred:
            n = (len(p) // self.message_len) * self.message_len
            if n == 0:
                continue
            grid = p[:n].reshape(-1, self.message_len)
            mode = np.zeros(self.message_len, np.int64)
            acc = 0.0
            for j in range(self.message_len):
                vals, counts = np.unique(grid[:, j], return_counts=True)
                mode[j] = vals[np.argmax(counts)]
                acc += counts.max() / grid.shape[0]
            acc /= self.message_len
            if best is None or acc > best[0]:
                best = (acc, mode, grid)
        if best is None:
            return {"messages": [], "confidences": [], "status": False}
        acc, mode, grid = best

        zeros = np.nonzero(mode == 0)[0]
        if len(zeros) == 0:
            return {"messages": [], "confidences": [float(acc)], "status": False}
        end = int(zeros.min())
        symbols = np.concatenate([mode[end + 1:], mode[:end]]) - 1
        if np.any(symbols < 0) or np.any(symbols > 3):
            # extra terminators or out-of-range symbols: no valid message
            return {"messages": [], "confidences": [float(acc)], "status": False}
        confidence = float(np.mean(grid == mode[None]))
        return {"messages": [symbols_to_bytes(symbols)], "confidences": [confidence],
                "status": True}


# ---- the user's API ----


def load_watermarker(ckpt_dir: Optional[str] = None, device="cuda") -> Watermarker:
    """A Watermarker on ``device``; with ``ckpt_dir``, the SilentCipher
    checkpoints there (enc_c.ckpt, dec_c.ckpt, dec_m_0.ckpt, a ``module.``
    prefix stripped), else random weights from seed 0."""
    if ckpt_dir is None:
        return Watermarker(device=device)

    def load(name):
        state = torch.load(os.path.join(ckpt_dir, name), map_location="cpu", weights_only=True)
        return {k.removeprefix("module."): v for k, v in state.items()}

    params = wm.convert_torch_watermark_state(load("enc_c.ckpt"), load("dec_c.ckpt"),
                                              load("dec_m_0.ckpt"))
    return Watermarker(params, device=device)


def watermark(watermarker: Watermarker, audio: np.ndarray, sample_rate: int,
              key: Sequence[int] = CSM_1B_GH_WATERMARK,
              message_sdr: float = 36.0) -> Tuple[np.ndarray, int]:
    """(watermarked audio, its sample rate: at most 44.1 kHz)."""
    out = watermarker.encode_wav(audio, sample_rate, key, message_sdr)
    out_sr = min(MODEL_SR, sample_rate)
    if out_sr != sample_rate:
        out = audio_io.resample(out, sample_rate, out_sr)
    return out, out_sr


def verify(watermarker: Watermarker, audio: np.ndarray, sample_rate: int,
           key: Sequence[int] = CSM_1B_GH_WATERMARK) -> bool:
    res = watermarker.decode_wav(audio, sample_rate, phase_shift_decoding=True)
    return bool(res["status"]) and res["messages"][0] == list(key)


def check_audio_from_file(path: str, ckpt_dir: Optional[str] = None, device="cuda") -> bool:
    w = load_watermarker(ckpt_dir, device)
    audio, sr = audio_io.load_wav(path)
    is_marked = verify(w, audio, sr)
    print(f"{path}: {'watermarked' if is_marked else 'not watermarked'}")
    return is_marked
