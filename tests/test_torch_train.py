"""The port's trainer of the neural SNP caller against the JAX package's, on
the CPU.

JAX's threefry batch sampling cannot be reproduced in torch, so a trained
model is not duet_tpu's bytes; each piece of the training step is held
against duet_tpu's on the same numpy inputs instead:

- ``init_params``, ``_label_candidates`` and ``build_training_set``:
  array_equal;
- the class-weighted NLL on one fixed batch: rtol 1e-6;
- each parameter's gradient at the initial weights: atol 1e-7 (the
  largest gradient there is below 0.5);
- 20 Adam steps fed the same gradients, ``torch.optim.Adam`` against
  ``optax.adam(3e-3)``: atol 1e-6 on the parameters;
- ``params_to_numpy`` inverts ``params_from_numpy`` exactly.

A short ``train`` on a small corpus writes duet_tpu's ``.npz`` layout,
which both packages load to the same classes."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from duet_tpu.models import nn_snp as jnn
from duet_tpu_torch.models import nn_snp as tnn
from duet_tpu_torch.models import nn_snp_host as tnn_host

SMALL = dict(seeds=(11,), coverages=(8.0,), error_rates=(0.02,),
             contig_len=60_000)
KEYS = ("W1", "b1", "W2", "b2", "W3", "b3")


@pytest.fixture(scope="module")
def corpus():
    """duet_tpu's training corpus at the small size."""
    return jnn.build_training_set(**SMALL)


@pytest.fixture(scope="module")
def batch(corpus):
    """One fixed batch of 4096 rows: the corpus, then uniform features in
    [0, 1] with random labels; the class weights as train computes them."""
    X, y = corpus
    rng = np.random.default_rng(5)
    n_extra = 4096 - len(y)
    X = np.concatenate([X, rng.random((n_extra, jnn.N_FEATURES),
                                      dtype=np.float32)])
    y = np.concatenate([y, rng.integers(0, jnn.N_CLASSES, n_extra)])
    counts = np.bincount(y, minlength=jnn.N_CLASSES).astype(np.float64)
    class_w = np.sqrt(len(y) / np.maximum(counts, 1.0) / jnn.N_CLASSES
                      ).astype(np.float32)
    return X, y, class_w


def _params(source):
    return jnn.init_params(0) if source == "init" else jnn.load_params()


def _jax_loss(p, xb, yb, wb):
    """duet_tpu.models.nn_snp.train's loss_fn."""
    logits = jnn.apply(p, xb)
    ll = jax.nn.log_softmax(logits, axis=1)
    nll = -ll[jnp.arange(len(yb)), yb]
    return (nll * wb).sum() / wb.sum()


def _jax_value_and_grad(params, X, y, class_w):
    p = {k: jnp.asarray(v) for k, v in params.items()}
    yd = jnp.asarray(y)
    loss, g = jax.value_and_grad(_jax_loss)(p, jnp.asarray(X), yd,
                                            jnp.asarray(class_w)[yd])
    return float(loss), {k: np.asarray(v) for k, v in g.items()}


def _torch_value_and_grad(params, X, y, class_w):
    model = tnn.params_from_numpy(params).train()
    loss = tnn.weighted_nll(model, torch.from_numpy(X), torch.from_numpy(y),
                            torch.from_numpy(class_w))
    loss.backward()
    loss = loss.detach()
    grads = {}
    for k, layer in enumerate((model.fc1, model.fc2, model.fc3), 1):
        grads[f"W{k}"] = layer.weight.grad.numpy().T
        grads[f"b{k}"] = layer.bias.grad.numpy()
    return float(loss), grads


@pytest.mark.parametrize("seed", [0, 3])
def test_init_params_equal(seed):
    want, got = jnn.init_params(seed), tnn_host.init_params(seed)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype


@pytest.mark.parametrize("case", ["hits", "no_truth", "alt_mismatch"])
def test_label_candidates_equal(case):
    rng = np.random.default_rng(2)
    pos = np.sort(rng.choice(10_000, 300, replace=False)).astype(np.int64)
    alt = rng.integers(0, 4, 300).astype(np.uint8)
    pick = rng.choice(300, 120, replace=False)
    truth_pos = np.concatenate([pos[pick], rng.integers(10_000, 12_000, 40)])
    truth_alt = np.concatenate([alt[pick], rng.integers(0, 4, 40)]
                               ).astype(np.uint8)
    truth_gt = rng.integers(0, 2, (160, 2)).astype(np.int8)
    truth_gt[truth_gt.sum(axis=1) == 0, 0] = 1
    if case == "no_truth":
        truth_pos, truth_alt = truth_pos[:0], truth_alt[:0]
        truth_gt = truth_gt[:0]
    elif case == "alt_mismatch":
        truth_alt = (truth_alt + 1) % 4
    order = rng.permutation(len(truth_pos))    # truth in any order
    args = (pos, alt, truth_pos[order], truth_alt[order], truth_gt[order])
    want = jnn._label_candidates(*args)
    got = tnn_host._label_candidates(*args)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    if case == "hits":
        assert set(np.unique(got)) == {0, 1, 2}


def test_build_training_set_equal(corpus):
    X, y = tnn_host.build_training_set(**SMALL)
    np.testing.assert_array_equal(X, corpus[0])
    np.testing.assert_array_equal(y, corpus[1])
    assert X.dtype == corpus[0].dtype and y.dtype == corpus[1].dtype
    assert set(np.unique(y)) == {0, 1, 2}


@pytest.mark.parametrize("source", ["init", "shipped"])
def test_loss_equal(batch, source):
    params = _params(source)
    want, _ = _jax_value_and_grad(params, *batch)
    got, _ = _torch_value_and_grad(params, *batch)
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_gradients_equal(batch, seed):
    """At the start of training, where gradients stay below 0.5 (at the
    shipped weights they reach ~1, where float32's ulp is above 1e-7)."""
    params = jnn.init_params(seed)
    _, want = _jax_value_and_grad(params, *batch)
    _, got = _torch_value_and_grad(params, *batch)
    assert 1e-3 < max(float(np.abs(g).max()) for g in want.values()) < 0.5
    for k in KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-7,
                                   err_msg=k)


def test_adam_equal_on_given_gradients():
    """20 steps of optax.adam(3e-3) and torch.optim.Adam(lr=3e-3) fed the
    same gradients, some of them near zero."""
    params = jnn.init_params(0)
    rng = np.random.default_rng(9)
    grads = [{k: (rng.standard_normal(v.shape) * 0.05
                  * (rng.random(v.shape) > 0.1)).astype(np.float32)
              for k, v in params.items()} for _ in range(20)]

    opt = optax.adam(3e-3)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(p)
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state)
        p = optax.apply_updates(p, upd)

    model = tnn.params_from_numpy(params).train()
    topt = torch.optim.Adam(model.parameters(), lr=3e-3)
    for g in grads:
        for k, layer in enumerate((model.fc1, model.fc2, model.fc3), 1):
            layer.weight.grad = torch.from_numpy(
                np.ascontiguousarray(g[f"W{k}"].T))
            layer.bias.grad = torch.from_numpy(g[f"b{k}"])
        topt.step()
    got = tnn.params_to_numpy(model)
    for k in KEYS:
        np.testing.assert_allclose(got[k], np.asarray(p[k]), rtol=0,
                                   atol=1e-6, err_msg=k)
        assert not np.array_equal(got[k], params[k]), k


@pytest.mark.parametrize("source", ["init", "shipped"])
def test_params_to_numpy_inverts_params_from_numpy(source):
    params = _params(source)
    got = tnn.params_to_numpy(tnn.params_from_numpy(params))
    assert list(got) == list(KEYS)
    for k in KEYS:
        np.testing.assert_array_equal(got[k], params[k], err_msg=k)
        assert got[k].dtype == np.float32 and got[k].flags.c_contiguous


def test_train_writes_weights_duet_tpu_loads(corpus, tmp_path, monkeypatch):
    """30 steps on the small corpus: the loss falls, and the saved .npz
    loads through the port's load_model to duet_tpu's apply_np classes."""
    X, y = corpus
    monkeypatch.setattr(tnn, "build_training_set", lambda: (X, y))
    out = str(tmp_path / "w.npz")
    logs = []
    params = tnn.train(out, steps=30, device=torch.device("cpu"),
                       log=logs.append)
    losses = [float(m.rsplit(" ", 1)[1]) for m in logs
              if m.startswith("step ")]
    assert [m.split(":")[0] for m in logs if m.startswith("step ")] == \
        ["step 0", "step 29"]
    assert losses[-1] < losses[0]
    assert logs[0] == (f"training set: {len(y)} candidates, class counts "
                       f"{np.bincount(y, minlength=3).astype(float).tolist()}")
    assert sum(m.startswith("train recall[") for m in logs) == 3
    saved = jnn.load_params(out)
    for k in KEYS:
        np.testing.assert_array_equal(saved[k], params[k], err_msg=k)
    with torch.no_grad():
        cls = tnn.load_model(out)(torch.from_numpy(X)).argmax(1).numpy()
    np.testing.assert_array_equal(cls, jnn.apply_np(saved, X).argmax(1))


def test_main_trains_on_the_cpu(corpus, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tnn, "build_training_set", lambda: corpus)
    out = str(tmp_path / "sub" / "w.npz")
    assert tnn.main(["train", out, "--steps", "3", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines()[-1] == f"saved {out}"
    assert sorted(np.load(out).files) == sorted(KEYS)


def test_main_on_cuda_without_a_card_raises(monkeypatch, tmp_path):
    """--device cuda (the default) never trains on the CPU: on a host
    without a card it raises before building the corpus."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")

    def built():
        raise AssertionError("the corpus was built")

    monkeypatch.setattr(tnn, "build_training_set", built)
    for argv in (["train", str(tmp_path / "w.npz")],
                 ["train", str(tmp_path / "w.npz"), "--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tnn.main(argv)
    assert not (tmp_path / "w.npz").exists()
