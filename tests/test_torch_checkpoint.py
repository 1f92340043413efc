"""The port's checkpoint readers and writers against the JAX package's, on
files the tests write in their exact on-disk formats.

  * the port's ``.safetensors`` reader and writer against the
    ``safetensors`` package: every dtype it reads, 0-d and empty tensors,
    metadata, and the same bytes from both writers;
  * a torchtune ``ckpt.pt`` and ``.safetensors`` at ``tiny_file_args()``
    (tiny layers, the full 1B token geometry): the port's tree equals the
    JAX package's ``load_torch_checkpoint`` tree bit for bit, and export
    gives the file's tensors back;
  * a Hugging Face ``MimiModel`` state dict at full size: the port's Mimi
    tree equals the JAX package's bit for bit;
  * ``load_csm`` from those files gives the JAX package's ``load_csm``
    tokens at topk=1, in bf16, int8 and int4 and through the streaming
    route; ``CSMTrainer`` and ``csm-torch-train`` load a ``ckpt.pt``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csm_tpu import generator as jgen
from csm_tpu.codec import convert as jconvert
from csm_tpu.models.config import tiny_file_args as jtiny_file_args
from csm_tpu.utils import checkpoint_compat as jcompat
from csm_tpu.utils import safetensors_io as jsio
from csm_torch import generator as tgen
from csm_torch.codec import convert as tconvert
from csm_torch.data.tokenizers import ByteTokenizer
from csm_torch.models import config as tconfig
from csm_torch.utils import checkpoint_compat as tcompat
from csm_torch.utils import safetensors as tst
from csm_torch.utils import safetensors_io as tsio
from test_file_checkpoint_e2e import _write_csm_ckpt
from test_torch_generator import Recording

DTYPES = [np.float32, np.float16, np.int8, np.int32, np.int64, np.bool_]


def _leaves(tree, path=""):
    """{path: numpy array} of a tree of dicts, lists and NamedTuples (either
    package's), keyed so that the two packages' trees line up."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{path}/{k}"))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for k, v in zip(tree._fields, tree):
            out.update(_leaves(v, f"{path}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{path}/{i}"))
        return out
    if tree is None:
        return {path: None}
    if isinstance(tree, torch.Tensor):
        name = str(tree.dtype).removeprefix("torch.")
        tree = tree.detach().cpu()
        return {path: (name, (tree.float() if name == "bfloat16" else tree).numpy())}
    arr = np.asarray(tree)
    name = str(arr.dtype)
    return {path: (name, arr.astype(np.float32) if name == "bfloat16" else arr)}


def assert_same_tree(got, want):
    """Equal keys, dtypes, shapes and bits (bf16 compared through float32,
    which holds every bf16 value)."""
    a, b = _leaves(got), _leaves(want)
    assert sorted(a) == sorted(b)
    for k in a:
        if b[k] is None:
            assert a[k] is None, k
            continue
        (da, xa), (db, xb) = a[k], b[k]
        assert da == db and xa.shape == xb.shape, (k, da, db)
        np.testing.assert_array_equal(xa, xb, err_msg=k)


# ---------------------------------------------------------------- safetensors


def _arrays(rng):
    out = {}
    for dt in DTYPES:
        name = np.dtype(dt).name
        if dt is np.bool_:
            out[name] = rng.random((3, 5)) < 0.5
        elif np.issubdtype(dt, np.integer):
            out[name] = rng.integers(np.iinfo(dt).min, np.iinfo(dt).max, (7, 3), dtype=dt)
        else:
            out[name] = rng.standard_normal((4, 3, 2)).astype(dt)
        out[name + "_0d"] = out[name].reshape(-1)[:1].reshape(())
    out["empty"] = np.zeros((0, 4), np.float32)
    out["odd"] = np.arange(5, dtype=np.int8)  # pushes wider tensors off alignment
    return out


def test_safetensors_reads_the_package_files(tmp_path):
    from safetensors.numpy import save_file

    arrays = _arrays(np.random.default_rng(0))
    path = str(tmp_path / "a.safetensors")
    save_file(arrays, path, metadata={"format": "pt", "model_args": '{"x": 1}'})
    got, meta = tst.read(path)
    assert meta == {"format": "pt", "model_args": '{"x": 1}'}
    assert sorted(got) == sorted(arrays)
    for k, v in arrays.items():
        assert got[k].shape == v.shape and got[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v)


def test_safetensors_reads_bf16_from_the_torch_writer(tmp_path):
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(0)
    tensors = {"w": torch.randn(5, 3, generator=g).bfloat16(), "s": torch.tensor(2.5).bfloat16(),
               "h": torch.randn(3, generator=g).half(), "b": torch.tensor([True, False])}
    path = str(tmp_path / "t.safetensors")
    save_file(tensors, path)
    got, meta = tst.read(path)
    assert meta == {}
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def assert_same_file(a: str, b: str):
    """Two ``.safetensors`` files hold the same header (as JSON: the
    package orders ``__metadata__`` keys as its hash map iterates) and the
    same data bytes."""
    with open(a, "rb") as fa, open(b, "rb") as fb:
        ba, bb = fa.read(), fb.read()
    na, nb = (int.from_bytes(x[:8], "little") for x in (ba, bb))
    assert na == nb and json.loads(ba[8:8 + na]) == json.loads(bb[8:8 + nb])
    assert ba[8 + na:] == bb[8 + nb:]


def test_safetensors_writer_matches_the_package(tmp_path):
    """The port's file reads back in the package, and the two writers give
    the same file, bf16 included: the same bytes with one metadata key."""
    from safetensors.numpy import load_file
    from safetensors.torch import save_file

    tensors = {k: torch.from_numpy(v.copy()) for k, v in _arrays(np.random.default_rng(1)).items()}
    tensors["bf16"] = torch.randn(6, 2, generator=torch.Generator().manual_seed(2)).bfloat16()
    theirs, ours = str(tmp_path / "theirs.safetensors"), str(tmp_path / "ours.safetensors")
    for meta in ({"format": "csm-tpu"}, {"format": "csm-tpu", "model_args": '{"a": [1, 2]}'}):
        save_file(tensors, theirs, metadata=meta)
        tst.write(ours, tensors, meta)
        assert_same_file(theirs, ours)
    save_file(tensors, theirs, metadata={"format": "pt"})
    tst.write(ours, tensors, {"format": "pt"})
    with open(theirs, "rb") as a, open(ours, "rb") as b:
        assert a.read() == b.read()
    plain = {k: v for k, v in tensors.items() if k != "bf16"}
    tst.write(ours, plain)
    for k, v in load_file(ours).items():
        np.testing.assert_array_equal(v, plain[k].numpy())


def test_safetensors_reader_refuses_bad_offsets(tmp_path):
    path = str(tmp_path / "bad.safetensors")
    header = json.dumps({"w": {"dtype": "F32", "shape": [4], "data_offsets": [0, 12]}}).encode()
    with open(path, "wb") as f:
        f.write(len(header).to_bytes(8, "little") + header + bytes(16))
    with pytest.raises(ValueError, match="data_offsets"):
        tst.read(path)


# ---------------------------------------------------------------- CSM files


@pytest.fixture(scope="module")
def csm_files(tmp_path_factory):
    """A tiny-file-flavor ``ckpt.pt`` as the JAX package's e2e test writes
    it (float32 tensors under torchtune names), and the same tensors as a
    ``.safetensors`` file."""
    from safetensors.torch import save_file

    d = tmp_path_factory.mktemp("csm")
    pt = str(d / "ckpt.pt")
    _write_csm_ckpt(pt)
    st = str(d / "model.safetensors")
    save_file({k: v.contiguous() for k, v in torch.load(pt, weights_only=True).items()}, st)
    return pt, st


@pytest.mark.parametrize("kind", ["pt", "safetensors"])
def test_torch_checkpoint_tree_matches_jax(csm_files, kind):
    path = csm_files[0] if kind == "pt" else csm_files[1]
    got = tcompat.load_torch_checkpoint(path, tconfig.tiny_file_args())
    want = jcompat.load_torch_checkpoint(path, jtiny_file_args())
    assert_same_tree(got, want)


def test_export_round_trip(csm_files):
    """Export gives the file's tensors back, as the JAX package's does."""
    args = tconfig.tiny_file_args()
    state = torch.load(csm_files[0], weights_only=True)
    out = tcompat.export_to_torch_names(tcompat.convert_torch_state_dict(state, args), args)
    assert sorted(out) == sorted(state)
    for k, v in state.items():
        assert torch.equal(out[k], v), k
    jout = jcompat.export_to_torch_names(jcompat.load_torch_checkpoint(csm_files[0],
                                                                       jtiny_file_args()),
                                         jtiny_file_args())
    for k, v in jout.items():
        np.testing.assert_array_equal(out[k].numpy(), v)
    perm = tcompat.interleaved_to_half_perm(64)
    np.testing.assert_array_equal(perm.numpy(), jcompat.interleaved_to_half_perm(64))
    np.testing.assert_array_equal(tcompat.half_to_interleaved_perm(64).numpy(),
                                  jcompat.half_to_interleaved_perm(64))


def test_safetensors_io_between_the_packages(csm_files, tmp_path):
    """A params file written by either package loads in the other, with the
    model args from its metadata."""
    args = tconfig.tiny_file_args()
    params = tcompat.load_torch_checkpoint(csm_files[0], args)
    ours = tsio.save_params_safetensors(str(tmp_path / "ours.safetensors"), params, args)
    jparams, jargs = jsio.load_params_safetensors(ours)
    assert jargs == jtiny_file_args()
    assert_same_tree(params, jax.tree.map(np.asarray, jparams))
    theirs = jsio.save_params_safetensors(str(tmp_path / "theirs.safetensors"), jparams, jargs)
    got, targs = tsio.load_params_safetensors(theirs, device="cpu")
    assert targs == args
    assert_same_tree(got, params)
    assert_same_file(ours, theirs)


# ---------------------------------------------------------------- Mimi files


@pytest.fixture(scope="module")
def mimi_state():
    """A full-size random Hugging Face ``MimiModel`` state dict (the layout
    of the kyutai/mimi file)."""
    import transformers

    torch.manual_seed(0)
    model = transformers.MimiModel(transformers.MimiConfig())
    return {k: v.contiguous() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def mimi_file(mimi_state, tmp_path_factory):
    from safetensors.torch import save_file

    path = str(tmp_path_factory.mktemp("mimi") / "model.safetensors")
    save_file(mimi_state, path)
    return path


def test_mimi_state_dict_matches_jax(mimi_state):
    assert_same_tree(tconvert.convert_mimi_state_dict(mimi_state),
                     jconvert.convert_mimi_state_dict(mimi_state))


def test_mimi_file_matches_jax(mimi_file, tmp_path):
    want = jconvert.load_mimi_checkpoint(mimi_file)
    assert_same_tree(tconvert.load_mimi_checkpoint(mimi_file), want)
    pt = str(tmp_path / "mimi.pt")  # the torch.save'd form takes the other branch
    torch.save(tst.read(mimi_file)[0], pt)
    assert_same_tree(tconvert.load_mimi_checkpoint(pt), want)


# ---------------------------------------------------------------- load_csm


def _tokens(gen, **kw):
    """The codes a Generator hands to its codec for one topk=1 generate (the
    codec itself is not run)."""
    rec = gen.mimi = Recording(gen.mimi)
    rec.decode = lambda codes: rec.decoded.append(np.array(codes)) or np.zeros(
        np.array(codes).shape[1] * 1920, np.float32)
    gen.generate("files to tokens", speaker=1, max_audio_length_ms=400, temperature=1.0,
                 topk=1, **kw)
    return rec.decoded


class _EagerJax:
    """``jax`` as csm_tpu/generator.py sees it, with ``jit`` a no-op.  Its
    ``load_csm`` jits the int4 quantizer, and XLA's fused version rounds
    some of the bf16 codes otherwise than the eager quantizer, which the
    port's equals bit for bit (tests/test_torch_quantize.py)."""

    jit = staticmethod(lambda fn, **kw: fn)

    def __getattr__(self, name):
        return getattr(jax, name)


@pytest.mark.parametrize("quantize", ["none", "int8", "int4", "int4-streaming"])
def test_load_csm_from_files_matches_jax(csm_files, mimi_file, monkeypatch, quantize):
    """``load_csm(ckpt_path, mimi_path)``: in bf16 the port's weights (fused,
    quantized) and codec equal the JAX package's bit for bit; in float32 its
    codes at topk=1 equal the JAX package's.  (In bf16 the two packages'
    codes part after a few frames: they round bf16 intermediates
    differently.)  The streaming route (the 8B flavor's) is taken at tiny
    width by lowering its size threshold in both packages."""
    monkeypatch.setenv("CSM_TPU_ALLOW_BYTE_TOKENIZER", "1")
    mode = quantize.split("-")[0]
    if quantize.endswith("streaming"):
        monkeypatch.setattr(jgen, "_STREAMING_LOAD_BYTES", 0)
        monkeypatch.setattr(tgen, "_STREAMING_LOAD_BYTES", 0)
    elif mode == "int4":
        monkeypatch.setattr(jgen, "jax", _EagerJax())

    def load(jdtype, tdtype):
        gj = jgen.load_csm(csm_files[0], mimi_path=mimi_file, quantize=mode,
                           args=jtiny_file_args(), compute_dtype=jdtype)
        gt = tgen.load_csm(csm_files[0], mimi_path=mimi_file, quantize=mode,
                           args=tconfig.tiny_file_args(), compute_dtype=tdtype, device="cpu",
                           text_tokenizer=ByteTokenizer())
        return gj, gt

    gj, gt = load(jnp.bfloat16, torch.bfloat16)
    assert isinstance(gt.params["backbone"]["wqkv"], torch.Tensor) == (mode == "none")
    assert_same_tree(gt.params, jax.tree.map(np.asarray, gj.params))
    assert_same_tree(gt.mimi.params, jax.tree.map(np.asarray, gj.mimi.params))
    gj, gt = load(jnp.float32, torch.float32)
    want, got = _tokens(gj), _tokens(gt)
    assert len(got) == len(want) == 1 and got[0].shape == want[0].shape
    np.testing.assert_array_equal(got[0], want[0])


def test_load_csm_reads_a_training_checkpoint(tmp_path):
    """A ``csm-torch-train`` checkpoint directory loads with its own args."""
    from csm_torch.training import checkpoint as tckpt
    from csm_torch.training.optimizer import TrainState
    from csm_torch.utils.params import random_csm_params

    args = tconfig.tiny_test_args()
    params = random_csm_params(args, seed=3)
    path = tckpt.save_checkpoint(str(tmp_path), "step_1", TrainState(params, None, 1), args)
    g = tgen.load_csm(path, compute_dtype=torch.float32, device="cpu",
                      text_tokenizer=ByteTokenizer())
    assert g.args == args
    assert torch.equal(g.params["backbone"]["w2"], params["backbone"]["w2"])
    with pytest.raises(ValueError, match="training checkpoint directory"):
        tgen._load_csm_streaming(None, torch.bfloat16, "int4", False, args, None, "cpu",
                                 ByteTokenizer(), 0, ckpt_path=path)


def test_trainer_and_train_cli_load_a_ckpt(csm_files, mimi_file, tmp_path):
    from csm_torch.cli import train as tcli
    from csm_torch.training.trainer import CSMTrainer

    args = tconfig.tiny_file_args()
    want = tcompat.load_torch_checkpoint(csm_files[0], args)
    trainer = CSMTrainer(model_path=csm_files[0], args=args, output_dir=str(tmp_path / "out"),
                         device="cpu")
    assert_same_tree(trainer.params, want)
    ns = tcli.build_parser().parse_args(["--audio-dir", str(tmp_path), "--mimi-path", mimi_file,
                                         "--allow-byte-tokenizer", "--device", "cpu"])
    _, mimi = tcli.build_tokenizers(ns, args, torch.device("cpu"))
    assert_same_tree(mimi.params, tconvert.load_mimi_checkpoint(mimi_file))
