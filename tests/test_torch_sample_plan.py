"""The whole-loop sampler's plan (``decode_cuda.sample_plan``): pure
arithmetic on the model's widths and what the card holds at once, so it is
tested here with stand-ins in place of ``cudaOccupancyMaxActiveClusters``
and of the kernel's ``sample_loop_smem_bytes``.
"""

import pytest

from pytorch_generative_tpu_torch.ops import decode_cuda

# (h, w, n_blocks, C, n_heads, d_k, d_v, M): ImageGPT's reproduce() config,
# the C = 128 model the route still sends to the whole loop (n = 8), and
# C = 512 (reachable only by calling the kernel directly).
REPRODUCE = (28, 28, 8, 64, 2, 32, 32, 256)
DIMS = {"reproduce": REPRODUCE, "c128": (28, 28, 8, 128, 2, 64, 64, 512),
        "c512": (28, 28, 8, 512, 8, 64, 64, 2048), "odd": (5, 5, 3, 10, 2, 5, 5, 40)}


def _up4(v):
    return (v + 3) & ~3


def _smem_for(dims, cluster=decode_cuda.CLUSTER):
    """A stand-in for ``sample_loop_smem_bytes``: the shared memory of
    ``layout`` in ``csrc/sample_loop.cu`` (256 threads a CTA, 32 groups of 8
    lanes, a 3-stage ring) for plans of ``dims``."""
    h, w, n_blocks, c, n_heads, d_k, d_v, m = dims
    c_k, c_v = n_heads * d_k, n_heads * d_v
    f, r = 2 * c_k + c_v, cluster
    cf, fv, hm = (decode_cuda._max_cols(j, r) for j in (f, c_v, m))
    slices = decode_cuda._slices(dims, r)

    def smem_for(s, resident, stage):
        floats = (n_blocks * sum(_up4(k * j) for k, j in slices) if resident
                  else 3 * _up4(stage))
        floats += _up4(8 * c + 1) + 2 * (_up4(4 * c) + _up4(cf) + 2 * _up4(c) + _up4(hm))
        floats += _up4((h + 2) * (w + 2)) + _up4(s * 3 * (w + 2)) + _up4(s) + 2 * _up4(s * c)
        floats += _up4(s * max(f, r * c)) + _up4(s * max(r * (2 * n_heads + fv), r * c))
        floats += _up4(s * hm)
        floats += max(_up4(s * max(c, fv)), _up4(max(32, s * n_heads) * (d_v + 2)))
        floats += _up4(s * max(256, cf, c, hm))
        return 4 * floats

    return smem_for


def _plan(n, dims, max_clusters_for):
    return decode_cuda.sample_plan(n, dims, max_clusters_for, _smem_for(dims))


def _cap(one_cta, two_ctas=None):
    """Clusters the card holds at once: ``one_cta`` with one CTA an SM,
    ``two_ctas`` once two fit (half the SM's shared memory)."""
    return lambda smem, samples: two_ctas if two_ctas and smem <= 116 * 1024 else one_cta


CAPS = {"h100": _cap(15, 30), "one": _cap(1), "sixteen": _cap(16)}


@pytest.mark.parametrize("cap", list(CAPS))
@pytest.mark.parametrize("dims", list(DIMS))
def test_every_n_from_1_to_256_is_covered_within_the_clusters_given(dims, cap):
    widths, max_clusters_for = DIMS[dims], CAPS[cap]
    slices = decode_cuda._slices(widths, decode_cuda.CLUSTER)
    for n in range(1, 257):
        plan = _plan(n, widths, max_clusters_for)
        assert plan.cluster == decode_cuda.CLUSTER
        assert 1 <= plan.clusters <= max_clusters_for(plan.smem, plan.samples)
        assert plan.clusters <= plan.groups
        assert plan.groups * plan.samples >= n > (plan.groups - 1) * plan.samples
        assert plan.smem == _smem_for(widths)(plan.samples, plan.resident, plan.stage)
        assert plan.smem <= decode_cuda.SMEM_LIMIT
        if plan.resident:
            assert plan.stage == 0
        else:  # a stage holds at least one row of every product
            assert plan.stage >= max(cols for _, cols in slices)


# n -> (samples a cluster, resident) at the reproduce() config with the
# H100's 15 clusters of 8 (one CTA an SM: the kernel's registers allow no
# second): the fewest samples a cluster that serve n in one wave, the
# weights resident while 1-3 samples' state fits beside them.
ONE_WAVE = {1: (1, True), 15: (1, True), 16: (2, True), 45: (3, True), 46: (4, False),
            64: (5, False), 256: (18, False)}


@pytest.mark.parametrize("n", list(ONE_WAVE))
def test_one_wave_with_the_fewest_samples_a_cluster(n):
    plan = _plan(n, REPRODUCE, _cap(15))
    assert (plan.samples, plan.resident) == ONE_WAVE[n]
    assert plan.clusters == plan.groups == -(-n // plan.samples) <= 15


def test_reproduce_weights_stay_in_shared_memory_at_the_main_path():
    """n = 16 at the reproduce() config: with 16 clusters one sample each,
    with the H100's 15 two; every block's weight slices resident."""
    assert _plan(16, REPRODUCE, _cap(16))[:6] == (8, 16, 1, 16, True, 0)
    assert _plan(16, REPRODUCE, _cap(15))[:6] == (8, 8, 2, 8, True, 0)
    streamed = _plan(256, REPRODUCE, _cap(15, 30))
    assert not streamed.resident and (streamed.samples, streamed.clusters) == (9, 29)


def test_more_groups_than_clusters_when_the_card_is_full():
    """A single cluster at a time serves all n in turn."""
    plan = _plan(256, REPRODUCE, _cap(1))
    assert plan.clusters == 1 and plan.groups * plan.samples >= 256 and plan.groups > 1


def test_no_plan_raises():
    with pytest.raises(ValueError, match="no plan"):
        _plan(4, REPRODUCE, lambda smem, samples: 0)
    with pytest.raises(ValueError, match="at least one sample"):
        _plan(0, REPRODUCE, _cap(15))
