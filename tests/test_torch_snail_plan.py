"""The PixelSNAIL whole-loop sampler's plan (``snail_decode_cuda.snail_plan``)
with stand-in callables for the card's occupancy and the kernel's shared
memory, at n = 1, 16, 64 and 256 and at the widths the card tests run.

Arithmetic only: no kernel is built and nothing is allocated. The stand-ins
are not the kernel's layout: the plan must hold its rules for any callables
(never more clusters than the occupancy gives, a stage that holds a row of
the widest piece and no less than ``MIN_STAGE`` floats or the largest
piece, a cluster that splits C in units of 4, the fewest waves).
"""

import pytest

from pytorch_generative_tpu_torch.ops import snail_decode_cuda as sdc

LIMIT = sdc.HOPPER_SMEM - 4096
# (h, w, n_blocks, n_rb, C, C2, d_k, d_v)
REPRODUCE = (28, 28, 8, 2, 64, 32, 4, 32)
DIMS = {
    "reproduce": REPRODUCE,
    "tiny": (8, 8, 2, 2, 16, 8, 4, 8),
    "c32": (8, 8, 2, 2, 32, 16, 4, 8),
    "c128": (8, 8, 2, 2, 128, 64, 4, 8),
    "c128-28x28": (28, 28, 8, 2, 128, 64, 4, 32),
    "dv32": (8, 8, 2, 2, 16, 8, 4, 32),
    "rb1": (8, 8, 2, 1, 16, 8, 4, 8),
}


def _smem_for(dims):
    """A stand-in for the kernel's shared memory: the ring, each sample's
    taps a few positions ahead and a few activations, in bytes."""
    h, w, nb, nr, c, c2, d_k, d_v = dims

    def smem_for(cluster, samples, stage, depth):
        per_sample = nb * nr * 4 * (c // cluster) + 12 * c + nb * (d_k + d_v)
        return 4 * (depth * stage + 8 * c + nb * 4 * c + samples * per_sample + 2048)

    return smem_for


def _occupancy(calls):
    """A stand-in for cudaOccupancyMaxActiveClusters: 132 SMs, one CTA an SM
    above half the shared memory, two below, 15 / 8 * 8 clusters of 8."""
    def max_clusters_for(cluster, smem, samples):
        per_sm = 1 if smem > sdc.HOPPER_SMEM // 2 else 2
        cap = 120 * per_sm // cluster
        calls.append((cluster, smem, samples, cap))
        return cap

    return max_clusters_for


def _plan(n, dims, limit=LIMIT):
    calls = []
    plan = sdc.snail_plan(n, dims, _occupancy(calls), _smem_for(dims), limit)
    return plan, calls


@pytest.mark.parametrize("n", [1, 16, 64, 256])
@pytest.mark.parametrize("name", list(DIMS))
def test_plan_keeps_its_rules(name, n):
    dims = DIMS[name]
    plan, calls = _plan(n, dims)
    c = dims[4]
    shapes = sdc._piece_shapes(dims, plan.cluster)
    # Never more clusters than the card holds for this instance and memory.
    cap = [k for cl, smem, s, k in calls
           if (cl, smem, s) == (plan.cluster, plan.smem, plan.samples)]
    assert cap and plan.clusters <= cap[0]
    assert 1 <= plan.clusters <= plan.groups
    assert plan.groups == -(-n // plan.samples) and 1 <= plan.samples <= sdc.MAX_SAMPLES
    assert plan.cluster in sdc.CLUSTERS and c % (4 * plan.cluster) == 0
    assert plan.depth in sdc.DEPTHS
    assert plan.smem == _smem_for(dims)(plan.cluster, plan.samples, plan.stage, plan.depth)
    assert plan.smem <= LIMIT
    assert plan.stage % 4 == 0
    largest = sdc._up4(max(k * j for k, j in shapes))
    assert max(max(j for _, j in shapes), min(largest, sdc.MIN_STAGE)) <= plan.stage <= largest


@pytest.mark.parametrize("n", [1, 16, 64, 256])
@pytest.mark.parametrize("name", list(DIMS))
def test_plan_takes_the_fewest_waves_then_samples(name, n):
    """No (cluster, samples, depth) that fits with the least stage the plan
    takes runs n in fewer waves, or in as many with fewer samples a group."""
    dims = DIMS[name]
    plan, _ = _plan(n, dims)
    waves = -(-plan.groups // plan.clusters)
    smem_for = _smem_for(dims)
    for cluster in sdc.CLUSTERS:
        if dims[4] % (4 * cluster):
            continue
        shapes = sdc._piece_shapes(dims, cluster)
        if max(j for _, j in shapes) > sdc.MAX_COLS:
            continue
        least = max(max(j for _, j in shapes),
                    min(sdc._up4(max(k * j for k, j in shapes)), sdc.MIN_STAGE))
        for samples in range(1, min(n, sdc.MAX_SAMPLES) + 1):
            for depth in sdc.DEPTHS:
                smem = smem_for(cluster, samples, least, depth)
                if smem > LIMIT:
                    continue
                cap = _occupancy([])(cluster, smem, samples)
                assert (waves, plan.samples) <= (-(-(-(-n // samples)) // cap), samples)


def test_reproduce_config_runs_n16_in_one_wave_a_sample_a_cluster():
    plan, _ = _plan(16, REPRODUCE)
    assert plan.cluster == sdc.CLUSTERS[0] and plan.samples == 1
    assert plan.groups <= plan.clusters


def test_n256_takes_several_groups_a_cluster_where_few_clusters_fit():
    plan = sdc.snail_plan(256, REPRODUCE, lambda cluster, smem, samples: 4,
                          _smem_for(REPRODUCE), LIMIT)
    assert plan.clusters == 4 and plan.samples == sdc.MAX_SAMPLES
    assert plan.groups == 32 > plan.clusters


@pytest.mark.parametrize("dims,match", [
    pytest.param((8, 8, 2, 2, 20, 10, 4, 8), "multiples of 4", id="c2-10"),
    pytest.param((8, 8, 2, 2, 16, 8, 6, 8), "multiples of 4", id="dk-6"),
    pytest.param((8, 8, 2, 2, 16, 8, 4, 64), "<= 32", id="dv-64"),
    pytest.param((28, 28, 8, 2, 2048, 1024, 4, 32), "no plan", id="c2048"),
])
def test_a_size_without_a_plan_raises(dims, match):
    with pytest.raises(ValueError, match=match):
        _plan(16, dims)


def test_a_shared_memory_limit_too_small_raises():
    with pytest.raises(ValueError, match="no plan"):
        _plan(16, REPRODUCE, limit=16 * 1024)


def test_no_samples_raises():
    with pytest.raises(ValueError, match="at least one sample"):
        _plan(0, REPRODUCE)


def test_a_small_shared_memory_limit_chunks_the_pieces():
    """Where the largest piece does not fit a stage, the stage holds as many
    of its rows as fit, and at least one row of the widest piece."""
    dims = DIMS["c128-28x28"]
    plan, _ = _plan(1, dims)
    shapes = sdc._piece_shapes(dims, plan.cluster)
    assert plan.stage < max(k * j for k, j in shapes)
    assert plan.stage >= max(j for _, j in shapes)
