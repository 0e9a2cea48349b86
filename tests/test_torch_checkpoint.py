"""The port's checkpointer (``repro_torch.checkpoint.checkpointer``): the
twins of the reference's ``tests/test_checkpoint.py`` on torch trees, the
on-disk form shared with the reference (raw leaf bytes, ``manifest.json``,
an atomically published directory), and the port's key paths.

Round trips are held bit for bit.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import checkpointer as jck  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import checkpointer as ck  # noqa: E402
from repro_torch.launch.train import main  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig, init_opt_state  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these tiny CPU models, restored after each
    test: with the default (a thread a core) a test slows ~70x when
    parallel test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree():
    gen = torch.Generator().manual_seed(0)
    return {
        "a": torch.randn((8, 8), generator=gen),
        "nested": {"b": torch.arange(10, dtype=torch.int32), "c": torch.ones((3,), dtype=torch.bfloat16)},
    }


def _leaves(tree):
    return [t for _, t in ck._flatten(tree)]


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(ck._raw(a), ck._raw(b))


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    ck.save(str(tmp_path), 5, t)
    got, step = ck.restore(str(tmp_path), t)
    assert step == 5
    for a, b in zip(_leaves(t), _leaves(got)):
        assert a is not b and _bits_equal(a, b)


def test_latest_step_ignores_incomplete(tmp_path):
    t = _tree()
    ck.save(str(tmp_path), 1, t)
    ck.save(str(tmp_path), 2, t)
    os.makedirs(tmp_path / "step_00000003")  # a directory without manifest (killed mid-save)
    os.makedirs(tmp_path / "step_00000004.tmp")
    assert ck.latest_step(str(tmp_path)) == 2


def test_restore_rejects_shape_mismatch(tmp_path):
    ck.save(str(tmp_path), 1, {"a": torch.ones(4)})
    with pytest.raises(ValueError):
        ck.restore(str(tmp_path), {"a": torch.ones(5)})


def test_restore_rejects_mismatched_key_paths(tmp_path):
    ck.save(str(tmp_path), 1, {"a": torch.ones(4), "b": torch.ones(2)})
    with pytest.raises(ValueError, match="key paths"):
        ck.restore(str(tmp_path), {"a": torch.ones(4), "c": torch.ones(2)})
    with pytest.raises(ValueError, match="key paths"):
        ck.restore(str(tmp_path), {"a": torch.ones(4)})


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        ck.restore(str(tmp_path / "nope"), {"a": torch.ones(1)})


def test_prune_old_keeps_latest(tmp_path):
    t = {"a": torch.ones(2)}
    for s in range(6):
        ck.save(str(tmp_path), s, t)
    ck.prune_old(str(tmp_path), keep=2)
    assert ck.latest_step(str(tmp_path)) == 5
    assert len(sorted(p for p in os.listdir(tmp_path) if p.startswith("step_"))) == 2


def test_async_checkpointer(tmp_path):
    saver = ck.AsyncCheckpointer(str(tmp_path), keep=2)
    t = _tree()
    for s in (1, 2, 3):
        saver.submit(s, t)
    saver.close()
    assert ck.latest_step(str(tmp_path)) == 3


def test_async_checkpointer_saves_the_state_at_submit(tmp_path):
    """Training updates its tensors in place: a submit copies them first."""
    saver = ck.AsyncCheckpointer(str(tmp_path))
    t = {"a": torch.zeros(3)}
    saver.submit(1, t)
    t["a"] += 7.0
    saver.close()
    got, _ = ck.restore(str(tmp_path), {"a": torch.empty(3)})
    assert torch.equal(got["a"], torch.zeros(3))


def test_async_checkpointer_raises_a_failed_save(tmp_path):
    (tmp_path / "file").write_text("")
    saver = ck.AsyncCheckpointer(str(tmp_path / "file"))  # not a directory: the save fails
    saver.submit(1, {"a": torch.ones(2)})
    with pytest.raises(OSError):
        saver.close()


def test_manifest_contents(tmp_path):
    d = ck.save(str(tmp_path), 7, {"a": torch.ones((4, 2))})
    man = json.load(open(os.path.join(d, "manifest.json")))
    assert man["step"] == 7
    assert man["keys"] == ["a"]
    assert man["leaves"][0] == {"file": "arr_00000.npy", "shape": [4, 2], "dtype": "float32", "bytes": 32}


def test_leaf_files_are_the_reference_bytes(tmp_path):
    """The same arrays saved by both packages give the same leaf files and
    leaf records; only the tree's description differs (``keys`` here, a jax
    ``treedef`` there)."""
    a = np.random.default_rng(0).standard_normal((5, 3)).astype(np.float32)
    b = np.arange(4, dtype=np.int32)
    jd = jck.save(str(tmp_path / "ref"), 3, {"a": jnp.asarray(a), "b": jnp.asarray(b), "c": jnp.ones(2, jnp.bfloat16)})
    d = ck.save(str(tmp_path / "port"), 3, {"a": torch.from_numpy(a), "b": torch.from_numpy(b),
                                            "c": torch.ones(2, dtype=torch.bfloat16)})
    jman, man = (json.load(open(os.path.join(x, "manifest.json"))) for x in (jd, d))
    assert man["leaves"] == jman["leaves"] and man["step"] == jman["step"] == 3
    for leaf in man["leaves"]:
        np.testing.assert_array_equal(np.load(os.path.join(d, leaf["file"])), np.load(os.path.join(jd, leaf["file"])))


def test_params_and_opt_state_roundtrip(tmp_path):
    """A model's parameter tree and its AdamW state (bf16 moments), as the
    launcher saves them: key paths by parameter name, bitwise leaves, a fresh
    module that keeps the parameters' ``requires_grad``, ``like`` unchanged."""
    cfg = configs.reduced_config(configs.get_config("qwen2-0.5b"))
    params = Model(cfg).init(torch.Generator().manual_seed(1))
    params.requires_grad_(True)
    opt = init_opt_state(params, AdamWConfig(state_dtype=torch.bfloat16))
    opt = opt._replace(step=opt.step + 4, m={k: v + 0.25 for k, v in opt.m.items()})
    d = ck.save(str(tmp_path), 4, (params, opt))
    keys = json.load(open(os.path.join(d, "manifest.json")))["keys"]
    assert keys[0] == "0.embed.table" and "1.m.seg0.1.l0.mixer.wq" in keys and "1.step" in keys
    like = (Model(cfg).init(torch.Generator().manual_seed(2)), init_opt_state(params, AdamWConfig(state_dtype=torch.bfloat16)))
    before = [t.clone() for t in _leaves(like)]
    (got_p, got_opt), step = ck.restore(str(tmp_path), like)
    assert step == 4 and int(got_opt.step) == 4 and type(got_opt) is type(opt)
    assert type(got_p) is type(params) and all(p.requires_grad is False for p in got_p.parameters())
    for a, b in zip(_leaves((params, opt)), _leaves((got_p, got_opt))):
        assert _bits_equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(before, _leaves(like)))


def test_train_resume_continuity(tmp_path):
    """Port of ``test_train_resume_continuity``: a resumed run continues from
    the checkpoint."""
    argv = ["--device", "cpu", "--arch", "qwen2-0.5b", "--batch", "4", "--seq", "16", "--ckpt", str(tmp_path), "--quiet"]
    a = main(argv + ["--steps", "6", "--ckpt-every", "3"])
    assert ck.latest_step(str(tmp_path)) == 6
    b = main(argv + ["--steps", "10", "--resume"])
    # the resumed run trains only steps 6..9 and keeps improving
    assert len(b["losses"]) == 4
    assert b["losses"][-1] < a["losses"][0]


def test_resumed_run_is_the_uninterrupted_run(tmp_path):
    """The pipeline is index-based and the checkpoint holds the whole state,
    so steps 3..5 after a restart are the uninterrupted run's, bit for bit."""
    argv = ["--device", "cpu", "--batch", "2", "--seq", "8", "--microbatches", "1", "--quiet"]
    whole = main(argv + ["--steps", "6"])
    main(argv + ["--steps", "3", "--ckpt", str(tmp_path)])
    resumed = main(argv + ["--steps", "6", "--ckpt", str(tmp_path), "--resume"])
    assert resumed["losses"] == whole["losses"][3:]
    for a, b in zip(whole["params"].parameters(), resumed["params"].parameters()):
        assert torch.equal(a, b)
