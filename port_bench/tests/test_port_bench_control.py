"""The control (the plain reference in TF32, the precision below the
configuration's float32 with TF32 off, in the program's place) fails the
cells' limits: at the cells' own sizes on the card, on the seeds whose
readings PERF.md gives; and its TF32, made by hand, rounds every product
on any shape (on the CPU)."""

import pytest

CASES = [("kitti75-train", 4100000001), ("kitti75-train", 4410000003),
         ("kitti75-train", 4410000014), ("waymo-train", 4420000001),
         ("waymo-train", 4420000003), ("waymo-train", 4420000014),
         ("kitti75-render", 4630000001), ("kitti75-render", 4630000003),
         ("kitti75-render", 4630000014), ("waymo-render", 4640000001),
         ("waymo-render", 4640000003), ("waymo-render", 4640000014)]


@pytest.mark.card
@pytest.mark.parametrize("workload,seed", CASES)
def test_control_fails_the_limits(card, workload, seed):
    from port_bench import control, harness
    limits = harness.cell_files(workload)[0]["limits"]
    got = control.numbers(workload, seed, card)
    assert any(got[k] > limits[k] for k in limits if k in got), (got, limits)


def test_tf32_rounds_every_product_on_any_shape():
    """The control's TF32 is by hand: a product's operands, and the
    gradients back into them, rounded to a 10-bit mantissa (ties to
    even), whatever kernel the library picks; outside, float32."""
    import torch
    from port_bench.reference.tf32 import precision, round_tf32
    x = torch.tensor([1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -11,
                      -(1 + 2 ** -11 + 2 ** -20), 0.0])
    assert round_tf32(x).tolist() == [1.0, 1 + 2 ** -9, -(1 + 2 ** -10), 0.0]
    g = torch.Generator().manual_seed(3)
    a = torch.randn(4, 6, generator=g, requires_grad=True)
    b = torch.randn(6, 2, generator=g)
    with precision(True):
        c = a @ b
        d = torch.einsum("ij,jk->ik", a, b)
    want = round_tf32(a.detach()) @ round_tf32(b)
    assert torch.equal(c.detach(), want) and torch.equal(d.detach(), want)
    assert not torch.equal(want, a.detach() @ b)
    up = torch.full_like(c, 1 + 2 ** -12)
    c.backward(up)
    assert torch.equal(a.grad, round_tf32(up @ round_tf32(b).T))
    with precision(False):
        assert torch.equal((a @ b).detach(), a.detach() @ b)
