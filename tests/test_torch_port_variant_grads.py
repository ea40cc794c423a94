"""Train-mode gradients of the decoder variants against `jax.grad`, on the CPU.

The combinations of (two_stage, bbox_reparam, lite_refpoint_refine) that
change the backward (the iterative refinement, or boxes as logits) and that
test_torch_port_variants.py and test_torch_port_presnet.py do not take to
`jax.grad`: two-stage logit boxes with the lite refinement (the backward
through the +inf logit proposals), one-stage reparameterized boxes with the
iterative refinement, and one-stage logit boxes with the lite refinement. At
the reduced size and with the helpers of test_torch_port_variants.py: the
train forward and loss on the same matching, and each parameter's gradient.
"""
import pytest

from test_torch_port_variants import (assert_train_forward_matches,
                                      assert_train_gradients_match, train_gradients, variant)


@pytest.fixture(scope="module", params=[(True, False, True, "sine"),
                                        (False, True, False, "learned"),
                                        (False, False, True, "learned")],
                ids=["two_stage_logits_lite", "one_stage_reparam_iterative",
                     "one_stage_logits_lite"])
def variant_gradients(request):
    two_stage, reparam, lite, embedding = request.param
    cfg = variant(two_stage, reparam, lite, embedding)
    return cfg, train_gradients(cfg)


def test_train_forward_and_loss_match_jax(variant_gradients):
    assert_train_forward_matches(*variant_gradients)


def test_train_gradients_match_jax_grad(variant_gradients):
    assert_train_gradients_match(*variant_gradients)
