"""The port's TPC-DS generator (`data/tpcdsgen.py`) against the reference's,
on the CPU: all 24 Arrow tables equal at two scale factors and two seeds
(schema, row count and every value), and `register_tpcds` giving the
session the same tables, capacities and row counts as the reference's."""

import numpy as np
import pytest
import torch

from datafusion_distributed_tpu.data import tpcdsgen as jgen
from datafusion_distributed_tpu.sql.context import SessionContext as JContext
from datafusion_distributed_tpu_torch.data import tpcdsgen as tgen
from datafusion_distributed_tpu_torch.sql.context import SessionContext as TContext
from tests.torch_port_helpers import np_of

torch.set_num_threads(1)

TABLES = 24


@pytest.mark.parametrize("seed", [0, 11])
@pytest.mark.parametrize("sf", [0.001, 0.01])
def test_gen_tpcds_equals_reference(sf, seed):
    ref = jgen.gen_tpcds(sf=sf, seed=seed)
    got = tgen.gen_tpcds(sf=sf, seed=seed)
    assert len(ref) == TABLES
    assert list(got) == list(ref)
    for name, table in ref.items():
        assert got[name].schema.equals(table.schema), name
        assert got[name].num_rows == table.num_rows, name
        assert got[name].equals(table), name


def test_register_tpcds_matches_reference():
    jctx, tctx = JContext(), TContext(device="cpu")
    jtabs = jgen.register_tpcds(jctx, sf=0.001, seed=3)
    ttabs = tgen.register_tpcds(tctx, sf=0.001, seed=3)
    assert list(ttabs) == list(jtabs)
    jcat, tcat = jctx.catalog.tables, tctx.catalog.tables
    assert sorted(tcat) == sorted(jcat)
    assert len(tcat) == TABLES
    for name in jtabs:
        j, t = jcat[name], tcat[name]
        assert t.names == j.names, name
        assert t.capacity == j.capacity, name
        assert int(t.num_rows) == int(j.num_rows) == jtabs[name].num_rows
        assert t.device == torch.device("cpu")
        for jc, tc in zip(j.columns, t.columns):
            n = int(j.num_rows)
            assert np.array_equal(np_of(tc.data)[:n], np_of(jc.data)[:n]), \
                name
