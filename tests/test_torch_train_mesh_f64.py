"""The ResNet18 and EfficientNet ``ZooTrainer`` over mesh positions in
f64 on the CPU: the model, the ImageNet constants and the batch in f64,
BatchNorm's statistics with them (``layers.BatchNorm`` promotes x to at
least f32, as Flax does).  Two and eight positions then equal mesh None
but for f64 rounding, so the f32 gaps that
``tests/test_torch_train_mesh_bn.py`` reads (up to 6.7e-5 of the largest
gradient here, 4.3e-4 on the card at 224^2) are f32 rounding through the
batch statistics, not the mesh; the two controls of that file stay as
far off as in f32.  The batch, the sizes and the controls are that
file's.

Gate: the step-1 loss, gradients (of the largest) and running statistics
(of the largest) within ``F64_REL``.  CPU readings (``-s`` prints them):
the loss within 1.2e-15 relative, the gradients within 6.1e-14, the
statistics within 7.6e-18; the controls' loss 1.2e-3 to 0.49 and
gradients 0.024 to 8.9 off.
"""

import numpy as np
import pytest

from tests import test_torch_train_mesh_bn as bn

F64_REL = 1e-12


def _f64_step1(net, mesh, control=None, monkeypatch=None):
    """The step-1 loss, gradients and running statistics
    (``bn._loss_and_grads``) with the model, the ImageNet constants and
    the batch in f64; ``control`` as ``bn._control``."""
    if control:
        bn._control(control, monkeypatch)
    t = bn._trainer(net, mesh)
    t.model.double()
    t._mean, t._inv_std = t._mean.double(), t._inv_std.double()
    imgs, refs = (x.double() for x in bn._batch(bn.NETS[net]))
    got = bn._loss_and_grads(t, imgs, refs)
    if control:
        monkeypatch.undo()
    return got


@pytest.mark.parametrize("positions", [2, 8])
@pytest.mark.parametrize("net", ["efficientnet", "resnet"])
def test_zoo_nets_in_f64_equal_none(net, positions, monkeypatch):
    """In f64 the mesh's statistics, sums and gradients are mesh None's
    but for rounding, and both controls stay off by as much as in f32."""
    def rel(got, want):
        loss, grads, stats = got
        loss0, grads0, stats0 = want
        gmax = max(float(g.abs().max()) for g in grads0.values())
        smax = max(float(np.abs(v).max()) for v in stats0.values())
        return (abs(loss / loss0 - 1),
                max(float((grads[k] - grads0[k]).abs().max())
                    for k in grads0) / gmax,
                max(float(np.abs(stats[k] - stats0[k]).max())
                    for k in stats0) / smax)

    want = _f64_step1(net, None)
    got = rel(_f64_step1(net, positions), want)
    controls = {c: rel(_f64_step1(net, positions, c, monkeypatch), want)
                for c in ("drop", "local")}
    print(f"{net} in f64 on {positions} positions: loss, gradients, "
          f"statistics {got}; controls {controls}")
    assert max(got) <= F64_REL
    for ctl in controls.values():
        assert ctl[0] > bn.LOSS_REL and ctl[1] > bn.GRAD_REL
