"""Typed error hierarchy is wired into the code paths it documents
(reference intent: modularity.rs:183-186
warn-and-break, hierarchy.rs:363-401 / multigrid.rs:582-608 error enums)."""

import dataclasses

import numpy as np
import pytest

from tpu_amg.errors import (
    CoarseningStalled,
    HierarchyError,
    MultigridBuildError,
)
from tpu_amg.hierarchy import HierarchyConfig, create_weights
from tpu_amg.interpolation import AggregationConfig, InterpolationConfig
from tpu_amg.partition import PartitionerConfig
from tpu_amg.preconditioners.multigrid_builder import MultigridConfig
from tpu_amg.sparse import CSR
from tpu_amg.utils.problems import poisson2d


def _identity_csr(n):
    idx = np.arange(n)
    return CSR.from_coo(idx, idx, np.ones(n), (n, n))


def _small_hierarchy():
    a = poisson2d(8)
    nn = np.ones((a.nrows, 1))
    return (
        HierarchyConfig(
            coarsest_dim=8,
            max_levels=2,
            interpolation_config=InterpolationConfig(
                kind="aggregation",
                aggregation=AggregationConfig(
                    candidate_dimension=1,
                    partitioner_config=PartitionerConfig(
                        coarsening_factor=8.0, max_improvement_iters=3
                    ),
                ),
            ),
        ).build(a, nn, create_weights(a, nn)),
        a,
    )


class TestCoarseningStalled:
    def test_strict_raises_on_edgeless_graph(self):
        """A diagonal matrix has no strength edges: matching cannot make
        progress, so strict mode must raise with the achieved factor."""
        a = _identity_csr(32)
        nn = np.ones((32, 1))
        cfg = PartitionerConfig(coarsening_factor=8.0, strict=True)
        with pytest.raises(CoarseningStalled) as e:
            cfg.build_partition(a, nn, create_weights(a, nn))
        assert e.value.target_cf == 8.0
        assert e.value.achieved_cf == 1.0

    def test_default_degrades_gracefully(self):
        """Without strict, the reference's warn-and-break behavior:
        a singleton partition comes back."""
        a = _identity_csr(32)
        nn = np.ones((32, 1))
        cfg = PartitionerConfig(coarsening_factor=8.0)
        p = cfg.build_partition(a, nn, create_weights(a, nn))
        assert p.num_aggs == 32


class TestHierarchyError:
    def test_add_level_dimension_mismatch(self):
        hier, a = _small_hierarchy()
        from tpu_amg.interpolation import GalerkinCoarse

        g0_r = hier.restrictions[0]
        g0_p = hier.interpolations[0]
        bad = GalerkinCoarse(
            interpolation=g0_p,
            restriction=g0_r,
            coarse_mat=_identity_csr(g0_p.ncols + 1),  # wrong coarse dim
            coarse_nn=np.ones((g0_p.ncols + 1, 1)),
            partition=hier.partitions[0],
            kind=hier.partition_kinds[0],
        )
        with pytest.raises(HierarchyError, match="dimension mismatch"):
            hier.add_level(bad, np.ones((g0_p.ncols + 1, 1)))


class TestMultigridBuildError:
    def test_corrupted_restriction_raises(self):
        hier, a = _small_hierarchy()
        # corrupt the level-0 restriction to an inconsistent shape
        hier.restrictions[0] = _identity_csr(a.nrows // 2)
        with pytest.raises(MultigridBuildError, match="assembly mismatch"):
            MultigridConfig(smoother="chebyshev").build(hier)
