"""The reference's own pieces against the port's plain versions where the
reference departs from a line-for-line copy."""
import pytest
import torch


@pytest.mark.parametrize("case", ["duplicates", "outside", "none_in_ring",
                                  "all_masked"])
def test_ring_placement_equals_the_ports(case):
    from bench.reference.collector import ring_scatter
    from repro_torch.kernels.ring_scatter.ref import ring_scatter_ref
    g = torch.Generator().manual_seed(7)
    F, H, W, R = 50, 4, 16, 300
    mem = torch.randint(-2**31, 2**31 - 1, (F, H, W), generator=g,
                        dtype=torch.int64).to(torch.int32)
    valid = torch.rand(F, H, generator=g) < 0.5
    pay = torch.randint(-2**31, 2**31 - 1, (R, W), generator=g,
                        dtype=torch.int64).to(torch.int32)
    flow = torch.randint(0, 8, (R,), generator=g)       # many duplicates
    hist = torch.randint(0, H, (R,), generator=g)
    mask = torch.rand(R, generator=g) < 0.7
    if case == "outside":
        flow = torch.randint(-5, F + 5, (R,), generator=g)
        hist = torch.randint(-1, H + 1, (R,), generator=g)
    elif case == "none_in_ring":
        flow = torch.full((R,), F + 1)
    elif case == "all_masked":
        mask = torch.zeros(R, dtype=torch.bool)
    a = ring_scatter(mem.clone(), valid.clone(), pay, flow, hist, mask)
    b = ring_scatter_ref(mem.clone(), valid.clone(), pay, flow, hist, mask)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
