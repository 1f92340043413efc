"""The port's watermarker against the JAX package's, on the CPU.

Both packages run on the same weights: the JAX package's random init
(``jax.random.key(0)``) bridged with ``params_from_jax``, or SilentCipher
files the test writes.  The JAX package resamples through its scipy route
here (its native loader switched off), as the port does.

Tolerances, float32 throughout: the STFT magnitude to 1e-5 of the largest
magnitude (two float32 DFT matmuls summing 1024 terms in other orders; the
phase where the magnitude is over 1e-2, to 1e-4 rad); the CNN stacks to
1e-5 of their largest output; ``encode_wav`` to 1e-5 of the input's peak
(the watermark itself is ~1e-1 of it); the message decoder's logits to
1e-5 of their largest, with equal argmax.  The message protocol runs with
``_decode_frames`` bypassed, as tests/test_watermarking.py runs it, and must
give the JAX package's results exactly.

Precision is pinned twice.  The port's STFT and watermarker run in IEEE
float32 whatever the process asked for (``stft.float32_math``), which
``test_float32_whatever_the_process_set`` checks with the process at "high"
and "medium" (oneDNN then rounds float32 operands to TF32 or bf16 where the
CPU has them: bf16 moves the magnitude by ~3e-3 of its peak, TF32 by
~2e-4).  And every test here runs with both packages' matmul precision at
"highest", so the CNN stacks, which the tests call outside the
watermarker, do not read what an earlier test in the process set.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csm_tpu.watermarking import model as jm
from csm_tpu.watermarking import stft as jstft
from csm_tpu.watermarking import watermarker as jw
from csm_torch.utils.params import params_from_jax
from csm_torch.watermarking import model as tm
from csm_torch.watermarking import stft as tstft
from csm_torch.watermarking import watermarker as tw
from test_file_checkpoint_e2e import _write_silentcipher_ckpts
from test_torch_checkpoint import assert_same_tree

KEY = tw.CSM_1B_GH_WATERMARK


@pytest.fixture(autouse=True)
def _scipy_resample(monkeypatch):
    """Both packages on their stdlib-wave + scipy route: the JAX package by
    its switch, the port by putting its plain versions in place of the
    native loader."""
    from csm_torch.data import audio as taudio_io

    monkeypatch.setenv("CSM_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(taudio_io, "load_wav", taudio_io.load_wav_plain)
    monkeypatch.setattr(taudio_io, "resample", taudio_io.resample_plain)


@pytest.fixture(autouse=True)
def _highest_precision():
    keep = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with jax.default_matmul_precision("highest"):
            yield
    finally:
        torch.set_float32_matmul_precision(keep)


@pytest.fixture(scope="module")
def params():
    """(JAX params, the same weights as port tensors)."""
    pj = jm.init_watermark_params(jax.random.key(0))
    return pj, params_from_jax(jax.tree.map(np.asarray, pj))


@pytest.fixture(scope="module")
def pair(params):
    pj, pt = params
    return jw.Watermarker(pj), tw.Watermarker(pt, device="cpu")


def _close(got, want, share, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= share * scale, f"{what}: max error {err:.3e} over {share:.0e} x {scale:.3e}"


def test_stft_istft_match_jax():
    x = (np.random.default_rng(0).standard_normal((2, 5000)) * 0.1).astype(np.float32)
    mag_j, ph_j = jstft.stft(jnp.asarray(x))
    mag_t, ph_t = tstft.stft(torch.from_numpy(x))
    _close(mag_t, mag_j, 1e-5, "magnitude")
    live = np.asarray(mag_j) > 1e-2
    dphi = np.angle(np.exp(1j * (ph_t.numpy() - np.asarray(ph_j))))
    assert np.abs(dphi[live]).max() < 1e-4
    y_j = jstft.istft(mag_j, ph_j, 5000)
    y_t = tstft.istft(mag_t, ph_t, 5000)
    _close(y_t, y_j, 1e-5, "istft")
    np.testing.assert_allclose(y_t.numpy(), x, atol=1e-5)  # the round trip


@pytest.mark.parametrize("precision", ["high", "medium"])
def test_float32_whatever_the_process_set(pair, precision):
    """With the process's float32 matmul precision lowered, the port's STFT,
    iSTFT and ``encode_wav`` still agree with the JAX package to the
    tolerances above, and the setting is back after each call."""
    torch.set_float32_matmul_precision(precision)
    backends = torch.backends.mkldnn.matmul.fp32_precision, torch.backends.cuda.matmul.fp32_precision
    x = (np.random.default_rng(0).standard_normal((2, 5000)) * 0.1).astype(np.float32)
    mag_j, ph_j = jstft.stft(jnp.asarray(x))
    mag_t, ph_t = tstft.stft(torch.from_numpy(x))
    _close(mag_t, mag_j, 1e-5, "magnitude")
    _close(tstft.istft(mag_t, ph_t, 5000), jstft.istft(mag_j, ph_j, 5000), 1e-5, "istft")
    wj, wt = pair
    audio = (np.random.default_rng(2).standard_normal(12_000) * 0.1).astype(np.float32)
    want = wj.encode_wav(audio, 24_000, KEY)
    _close(wt.encode_wav(audio, 24_000, KEY), want,
           1e-5 * np.abs(audio).max() / np.abs(want).max(), "encode_wav")
    assert torch.get_float32_matmul_precision() == precision
    assert (torch.backends.mkldnn.matmul.fp32_precision,
            torch.backends.cuda.matmul.fp32_precision) == backends


@pytest.mark.parametrize("stack", ["encoder", "message", "carrier_decoder", "msg_decoder"])
def test_cnn_stacks_match_jax(params, stack):
    pj, pt = params
    rng = np.random.default_rng(1)
    T = 6
    mag = np.abs(rng.standard_normal((2, 1, 513, T))).astype(np.float32)
    if stack == "encoder":
        want = jm.encoder_apply(pj["enc_c"], jnp.asarray(mag))
        got = tm.encoder_apply(pt["enc_c"], torch.from_numpy(mag))
    elif stack == "message":
        msg = np.eye(5, dtype=np.float32)[rng.integers(0, 5, (2, 1, T))].transpose(0, 1, 3, 2)
        want = jm.transform_message(pj["enc_c"], jnp.asarray(msg), 1024)
        got = tm.transform_message(pt["enc_c"], torch.from_numpy(msg), 1024)
    elif stack == "carrier_decoder":
        merged = rng.standard_normal((2, 96, 513, T)).astype(np.float32)
        want = jm.carrier_decoder_apply(pj["dec_c"], jnp.asarray(merged), 36.0, 512)
        got = tm.carrier_decoder_apply(pt["dec_c"], torch.from_numpy(merged), 36.0, 512)
    else:
        want = jm.msg_decoder_apply(pj["dec_m"], jnp.asarray(mag), 512)
        got = tm.msg_decoder_apply(pt["dec_m"], torch.from_numpy(mag), 512)
    _close(got, want, 1e-5, stack)


def test_encode_wav_matches_jax(pair):
    """24 kHz, 0.5 s: resampled to 44.1 kHz, encoded, resampled back."""
    wj, wt = pair
    audio = (np.random.default_rng(2).standard_normal(12_000) * 0.1).astype(np.float32)
    want = wj.encode_wav(audio, 24_000, KEY)
    got = wt.encode_wav(audio, 24_000, KEY)
    assert got.dtype == np.float32
    _close(got, want, 1e-5 * np.abs(audio).max() / np.abs(want).max(), "encode_wav")
    assert np.abs(got - audio).max() > 1e-3  # the watermark is there


@pytest.mark.parametrize("phase_shift_decoding,shift_step", [(False, 10), (True, 256)])
def test_decode_logits_match_jax(pair, phase_shift_decoding, shift_step):
    """The logits ``decode_wav`` reads, on the shift batch it builds, and
    what it reads from them."""
    wj, wt = pair
    audio = (np.random.default_rng(3).standard_normal(11_025) * 0.1).astype(np.float32)
    batches = {}
    for name, w in (("jax", wj), ("port", wt)):
        inner = w._decode_frames

        def keep(p, y, inner=inner, name=name):
            out = inner(p, y)
            batches[name] = (np.asarray(y), np.asarray(out))
            return out

        w._decode_frames = keep
        try:
            res = w.decode_wav(audio, 44_100, phase_shift_decoding, shift_step)
        finally:
            w._decode_frames = inner
        batches[name + "_res"] = res
    np.testing.assert_array_equal(batches["port"][0], batches["jax"][0])
    logits_t, logits_j = batches["port"][1], batches["jax"][1]
    assert logits_t.shape[0] == (2 if phase_shift_decoding else 1)
    _close(logits_t, logits_j, 1e-5, "logits")
    np.testing.assert_array_equal(logits_t.argmax(1), logits_j.argmax(1))
    assert batches["port_res"] == batches["jax_res"]


def test_chunked_shifts_equal_one_batch(params, monkeypatch):
    """One shift a chunk gives the logits of all shifts in one chunk."""
    _, pt = params
    y = torch.from_numpy((np.random.default_rng(4).standard_normal((3, 8000)) * 0.05)
                         .astype(np.float32))
    w = tw.Watermarker(pt, device="cpu")
    assert w.shifts_per_chunk(8000) >= 3
    whole = w._decode_frames(w.params, y)
    monkeypatch.setattr(tw, "DECODE_BUDGET_BYTES", 1)
    assert w.shifts_per_chunk(8000) == 1
    torch.testing.assert_close(w._decode_frames(w.params, y), whole, atol=1e-6, rtol=1e-5)


def test_shift_chunks_bounded_by_budget():
    """At the defaults a 10 s clip decodes several shifts a chunk and a 60 s
    clip one, each chunk's count of activations within the budget."""
    w = tw.Watermarker(tm.init_watermark_params(torch.Generator().manual_seed(0)), device="cpu")
    for seconds, want in ((10, 9), (60, 1)):
        n = seconds * tw.MODEL_SR
        assert w.shifts_per_chunk(n) == want
        per_shift = 4 * 128 * 512 * w._n_frames(n) * 4
        assert w.shifts_per_chunk(n) * per_shift <= tw.DECODE_BUDGET_BYTES


# ---- the message protocol, with the CNN bypassed ----


def _one_hot_rows(rows, dim):
    return np.eye(dim, dtype=np.float32)[rows].T


def _scenario(name, w):
    """(fake ``_decode_frames``, audio, sample rate, decode kwargs) of one
    scenario of tests/test_watermarking.py, for Watermarker ``w`` (either
    package's); fakes draw their noise from a generator of fixed seed."""
    sym = jw.bytes_to_symbols(KEY)
    rng = np.random.default_rng(8)
    audio = rng.standard_normal(44_100).astype(np.float32)
    if name == "rotated_tiling":
        def fake(p, y):
            n = w._n_frames(y.shape[1])
            tiled = jw.tile_message(sym, w.message_dim, n + 7)[:, 7:]
            return np.repeat(tiled[None], y.shape[0], axis=0)
        return fake, audio, 44_100, dict(phase_shift_decoding=False)
    if name in ("verify_key", "verify_wrong_key"):
        s = sym if name == "verify_key" else jw.bytes_to_symbols([1, 2, 3, 4, 5])
        return (lambda p, y: np.repeat(jw.tile_message(s, w.message_dim, 4096)[None],
                                       y.shape[0], axis=0)), audio, 44_100, None
    if name in ("crop_with_search", "crop_without_search"):
        hop, step, crop = w.hop, 10, 3 * w.hop - 40

        def fake(p, y):
            n = w._n_frames(y.shape[1])
            rows = []
            for si in range(y.shape[0]):
                off = crop + si * step
                if off % hop == 0:
                    rot = (off // hop) % w.message_len
                    rows.append(jw.tile_message(sym, w.message_dim, n + rot)[:, rot:])
                else:
                    rows.append(_one_hot_rows(rng.integers(0, w.message_dim, n), w.message_dim))
            return np.stack(rows)
        kw = dict(phase_shift_decoding=name == "crop_with_search", shift_step=step)
        return fake, audio[crop:], 44_100, kw
    if name.startswith("gain"):
        gain = float(name.split("_")[1])

        def fake(p, y):
            n = w._n_frames(y.shape[1])
            rows = []
            for si in range(y.shape[0]):
                power = float(np.mean(np.asarray(y[si]) ** 2))
                if abs(power / jw.AVERAGE_ENERGY_VCTK - 1.0) < 0.05:
                    rows.append(jw.tile_message(sym, w.message_dim, n))
                else:
                    rows.append(_one_hot_rows(rng.integers(0, w.message_dim, n), w.message_dim))
            out = np.stack(rows)
            if name.endswith("noisy"):  # ~20 % of the frames flipped to noise
                bad = rng.random(n) < 0.2
                out[:, :, bad] = _one_hot_rows(rng.integers(0, w.message_dim, int(bad.sum())),
                                               w.message_dim)
            return out
        return fake, audio * 0.05 * gain, 44_100, dict(phase_shift_decoding=False)
    raise ValueError(name)


SCENARIOS = {  # name → (status, message recovered)
    "rotated_tiling": True, "verify_key": True, "verify_wrong_key": False,
    "crop_with_search": True, "crop_without_search": False,
    "gain_0.1": True, "gain_1.0": True, "gain_8.0": True, "gain_1.0_noisy": True,
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_protocol_with_bypassed_cnn_matches_jax(pair, name):
    results = []
    for w in pair:
        fake, audio, sr, kw = _scenario(name, w)
        inner, w._decode_frames = w._decode_frames, fake
        try:
            mod = jw if w is pair[0] else tw
            results.append(mod.verify(w, audio, sr) if kw is None
                           else w.decode_wav(audio, sr, **kw))
        finally:
            w._decode_frames = inner
    res_j, res_t = results
    assert res_t == res_j
    found = res_t if kw is None else (res_t["status"] and res_t["messages"][0] == KEY)
    assert found is SCENARIOS[name]


def test_silence_is_left_alone(pair):
    _, wt = pair
    silent = np.zeros(24_000, np.float32)
    np.testing.assert_array_equal(wt.encode_wav(silent, 24_000, KEY), silent)
    assert wt.decode_wav(silent, 24_000)["status"] is False


@pytest.mark.parametrize("message", [KEY, [0, 0, 0, 0, 0], [255, 1, 128, 7, 64]])
def test_symbols_and_tiling_match_jax(message):
    sym = tw.bytes_to_symbols(message)
    np.testing.assert_array_equal(sym, jw.bytes_to_symbols(message))
    assert tw.symbols_to_bytes(sym) == jw.symbols_to_bytes(sym) == list(message)
    for n in (1, 21, 50, 863):
        np.testing.assert_array_equal(tw.tile_message(sym, 5, n), jw.tile_message(sym, 5, n))


def test_watermark_api_resamples(pair):
    _, wt = pair
    audio = (np.random.default_rng(5).standard_normal(24_000) * 0.1).astype(np.float32)
    out, sr = tw.watermark(wt, audio, 24_000)
    assert sr == 24_000 and out.shape == audio.shape and out.dtype == np.float32
    out48, sr48 = tw.watermark(wt, np.zeros(4800, np.float32), 48_000)
    assert sr48 == 44_100 and out48.shape == (4410,)


def test_load_watermarker_matches_jax_on_silentcipher_files(tmp_path):
    """Files in SilentCipher's layout (``main.{i}`` gated convs with
    BatchNorm, Dropout between the message decoder's convs), one of them
    under ``module.`` names: the port's tree equals the JAX package's
    ``convert_torch_watermark_state`` bit for bit."""
    ckpt = str(tmp_path)
    _write_silentcipher_ckpts(ckpt)
    path = tmp_path / "dec_c.ckpt"
    state = torch.load(path, weights_only=True)
    for k, v in state.items():  # non-trivial BatchNorm stats to fold
        if "running_var" in k or "running_mean" in k or "bn." in k:
            state[k] = v + torch.rand(v.shape, generator=torch.Generator().manual_seed(1))
    torch.save({"module." + k: v for k, v in state.items()}, path)

    got = tw.load_watermarker(ckpt, device="cpu").params
    load = lambda n: {k.removeprefix("module."): v for k, v in  # noqa: E731
                      torch.load(tmp_path / n, weights_only=True).items()}
    want = jm.convert_torch_watermark_state(load("enc_c.ckpt"), load("dec_c.ckpt"),
                                            load("dec_m_0.ckpt"))
    assert_same_tree(got, want)
    assert len(got["dec_m"]["layers"]) == 10 and got["dec_c"]["layers"][-1].w.shape[-1] == 1


def test_watermarker_needs_a_card_unless_asked(params):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tw.Watermarker(params[1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tw.load_watermarker()
