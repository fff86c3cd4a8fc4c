"""Port parity: the NPU's classification head (``cfg.detect`` off) against
the JAX package's ``npu_forward`` on the jnp path, on the CPU.

The head averages the backbone's features over H and W, applies a
non-firing dense layer and averages over T: logits [B, num_classes].  On
reduced spiking-YOLO and VGG, both port backends ("cuda" runs its
kernels' plain versions on CPU tensors): the parameter tree has the
reference's keys and shapes, the logits are within 1e-5 of JAX's and
the gradient of ``logits.sum()`` within 1e-5 (max |diff| over max
|want|, every leaf) of ``jax.grad``'s.  Weights come from the port's
init carried to JAX as numpy (the JAX init runs eagerly, op by op)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import reduced_snn as jax_reduced_snn
from repro.core.npu import init_npu as jax_init_npu
from repro.core.npu import npu_forward as jax_npu_forward
from repro_torch import convert
from repro_torch.core.npu import init_npu, npu_forward
from repro_torch.core.train import grads_of, with_leaves
from repro_torch.optim.adamw import tree_leaves

REL = 1e-5
B = 2


def _maxrel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.numpy()


@pytest.fixture(scope="module", params=["spiking_yolo", "spiking_vgg"])
def ref(request):
    jcfg = dataclasses.replace(jax_reduced_snn(request.param), detect=False)
    params = _numpy_tree(init_npu(torch.Generator().manual_seed(2),
                                  convert.snn_config(jcfg), device="cpu"))
    rng = np.random.default_rng(7)
    vox = (rng.random((jcfg.time_steps, B, jcfg.height, jcfg.width,
                       jcfg.in_channels)) < 0.1).astype(np.float32)

    def loss(p):
        logits = jax_npu_forward(p, vox, jcfg).raw_pred
        return jnp.sum(logits), logits
    (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))
    shapes = jax.eval_shape(lambda k: jax_init_npu(k, jcfg),
                            jax.random.PRNGKey(0))
    return dict(jcfg=jcfg, params=params, vox=vox,
                logits=np.asarray(logits),
                grads=dict(tree_leaves(jax.tree_util.tree_map(np.asarray,
                                                              grads))),
                shapes={k: tuple(v.shape) for k, v in tree_leaves(shapes)})


def _cfg(ref, backend):
    return dataclasses.replace(convert.snn_config(ref["jcfg"]),
                               backend=backend)


def test_init_has_the_reference_tree(ref):
    cfg = _cfg(ref, "torch")
    p = init_npu(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in tree_leaves(p)} == ref["shapes"]
    assert "cls" in p and "head" not in p
    assert p["cls"]["w"].shape == (p["ctrl_hidden"]["w"].shape[0],
                                   cfg.num_classes)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_classification_logits_match_jax(ref, backend):
    cfg = _cfg(ref, backend)
    params = convert.params_from_numpy(ref["params"], device="cpu")
    with torch.no_grad():
        out = npu_forward(params, torch.tensor(ref["vox"]), cfg)
    assert out.raw_pred.shape == (B, cfg.num_classes)
    np.testing.assert_allclose(out.raw_pred.numpy(), ref["logits"],
                               atol=REL, rtol=0)
    assert out.control.shape == (B, cfg.control_dim)
    assert 0.0 < float(out.sparsity) < 1.0


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_classification_grads_match_jax(ref, backend):
    cfg = _cfg(ref, backend)
    p, leaves = with_leaves(convert.params_from_numpy(ref["params"],
                                                      device="cpu"))
    logits = npu_forward(p, torch.tensor(ref["vox"]), cfg).raw_pred
    grads = grads_of(logits.sum(), p, leaves)
    worst = {k: _maxrel(g.numpy(), ref["grads"][k])
             for k, g in tree_leaves(grads)}
    assert set(worst) == set(ref["grads"])
    assert max(worst.values()) <= REL, sorted(worst.items(),
                                              key=lambda kv: -kv[1])[:3]
    # the logits reach the classifier and the backbone, not the control
    # head
    g = dict(tree_leaves(grads))
    assert float(g["cls/w"].abs().sum()) > 0
    assert float(g["ctrl_out/w"].abs().sum()) == 0
