"""The port's ``ray_tpu_torch.data`` against the JAX package's ``ray_tpu.data``.

Every case builds the same pipeline over the same seeded inputs in both
packages and compares what comes out: the reference on the conftest's
``ray_start_shared`` cluster, the port on its local pool of two worker
processes (``_private.local_tasks``). The UDFs are module-level functions
(``tests/_torch_data_apps.py``), which the port's workers import by name.

Tolerances: rows, their order and integer aggregates exactly; float
``Mean``, ``Std`` and ``Sum`` to 1e-12 relative; images exactly (copies).
Where a stage of tasks feeds the rows, both packages give its blocks in the
order the tasks finish, so those cases compare the rows as multisets; the
seeded shuffles start from blocks in a fixed order (``from_items``), the
"same block layout" under which the orders must be equal.

The cases are tests/test_data.py's list (block accessor, plan fusion,
range/map/filter/count, map_batches with tasks and actors, flat_map and
limit, repartition, sort, groupby with every aggregate, global aggregates,
zip and union, iter_batches formats and sizes, select/drop/add columns,
stats and schema, a custom datasource and datasink), the seeded
``random_shuffle`` in the reference's exact order, files written by each
package and read by the other (parquet, csv, json, tfrecords; text and
numpy files both read), and a lambda refused with the ``TypeError``.
"""

import math
import os

import numpy as np
import pytest

import _torch_data_apps as apps
import ray_tpu.data as rd_ref
from ray_tpu.data.block import BlockAccessor as RefAccessor
from ray_tpu_torch import data as rd
from ray_tpu_torch._private import local_tasks
from ray_tpu_torch.data.block import BlockAccessor


@pytest.fixture(scope="module")
def pool(ray_start_shared):
    """The port's pool (two workers) beside the reference's cluster; the
    store's directory must be gone after shutdown."""
    runtime = local_tasks.init(num_workers=2)
    yield runtime
    store = runtime.store.dir
    local_tasks.shutdown()
    assert not os.path.exists(store)


def _same(a, b) -> bool:
    """Equal Python values, NaN equal to NaN, types equal too."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    return a == b


def _rows_equal(port_rows, ref_rows, *, any_order: bool = False):
    """Equal rows; with ``any_order``, as multisets: a map stage's blocks
    come out in the order its tasks finish, in both packages."""
    if any_order:
        port_rows = sorted(port_rows, key=lambda r: repr(sorted(r.items())))
        ref_rows = sorted(ref_rows, key=lambda r: repr(sorted(r.items())))
    assert len(port_rows) == len(ref_rows)
    for p, r in zip(port_rows, ref_rows):
        assert _same(p, r), (p, r)


# ---------------------------------------------------------------- blocks
BLOCK_CASES = {
    "ints": {"a": [1, 2, 3]},
    "floats": {"a": [1.5, 2.0]},
    "ints_and_floats": {"a": [1, 2.5]},
    "ints_with_none": {"a": [1, None, 3]},
    "floats_with_none": {"a": [1.5, None]},
    "bools": {"a": [True, False]},
    "bools_with_none": {"a": [True, None]},
    "strings": {"a": ["x", "yy"], "b": np.array(["p", "qq"])},
    "strings_with_none": {"a": ["x", None]},
    "bytes": {"a": [b"x", b"yz"]},
    "all_none": {"a": [None, None]},
    "int32": {"a": np.arange(4, dtype=np.int32)},
    "float32": {"a": np.arange(4, dtype=np.float32) / 3},
    "nan": {"a": [1.0, float("nan")]},
    "object_ints": {"a": np.array([1, 2], dtype=object)},
    "mixed_str_int": {"a": [1, "a"]},
    "tensor": {"x": np.arange(24, dtype=np.float32).reshape(2, 3, 4)},
    "rows_of_tensors": [{"x": np.ones((2, 2)) * i, "i": i} for i in range(3)],
    "rows_with_none": [{"x": 1, "s": "a"}, {"x": None, "s": None}],
    "rows_of_lists": [{"x": [1, 2]}, {"x": [3, 4]}],
    "vwxyz": {"a": np.arange(5), "b": list("vwxyz")},
}


@pytest.mark.parametrize("name", sorted(BLOCK_CASES))
def test_block_accessor_matches_the_reference(name):
    case = BLOCK_CASES[name]
    port, ref = BlockAccessor.for_block(case), RefAccessor.for_block(case)
    assert port.num_rows() == ref.num_rows()
    ref_np, port_np = ref.to_numpy(), port.to_numpy()
    assert list(port_np) == list(ref_np)
    for key in ref_np:
        assert port_np[key].dtype == ref_np[key].dtype, key
        assert port_np[key].shape == ref_np[key].shape, key
        if ref_np[key].dtype == object:
            assert _same(port_np[key].tolist(), ref_np[key].tolist())
        else:
            np.testing.assert_array_equal(port_np[key], ref_np[key])
    _rows_equal(list(port.iter_rows()), list(ref.iter_rows()))
    schema = port.schema()
    assert schema.names == list(ref.schema().names)
    assert schema.types == [ref_np[k].dtype for k in ref_np]
    assert schema.shapes == [ref_np[k].shape[1:] for k in ref_np]
    # The port's block converts to the reference's table.
    table = port.to_arrow()
    assert table.schema.equals(ref.to_arrow().schema)
    _rows_equal(table.to_pylist(), ref.to_arrow().to_pylist())


def test_plan_fusion_matches_the_reference():
    from ray_tpu.data._internal import plan as ref_plan
    from ray_tpu_torch.data._internal import plan as port_plan

    def stages(mod):
        plan = mod.LogicalPlan([mod.Read(), mod.MapRows(fn=apps.double),
                                mod.Filter(fn=apps.div4), mod.RandomShuffle(),
                                mod.MapRows(fn=apps.double)])
        return [(type(s).__name__, s.describe()) for s in mod.plan_stages(plan)]

    assert stages(port_plan) == stages(ref_plan)
    assert [n for n, _ in stages(port_plan)] == ["SourceStage", "MapStage", "AllToAllStage",
                                                 "MapStage"]


# ---------------------------------------------------------------- pipelines
def _both(build, consume=lambda ds: ds.take_all()):
    """``consume(build(package))`` for the port and the reference."""
    return consume(build(rd)), consume(build(rd_ref))


def test_range_map_filter_count(pool):
    port, ref = _both(lambda m: m.range(100, parallelism=4).map(apps.double).filter(apps.div4),
                      lambda ds: ds.count())
    assert port == ref == 50


def test_map_batches_numpy(pool):
    port, ref = _both(lambda m: m.range(32, parallelism=2).map_batches(apps.square))
    _rows_equal(port, ref, any_order=True)
    assert sorted(r["sq"] for r in port) == [i * i for i in range(32)]


def test_map_batches_actor_compute(pool):
    port, ref = _both(lambda m: m.range(20, parallelism=2).map_batches(apps.AddState,
                                                                       batch_size=5))
    assert sorted(r["y"] for r in port) == sorted(r["y"] for r in ref) == [1000 + i
                                                                          for i in range(20)]


def test_flat_map_and_limit(pool):
    port, ref = _both(lambda m: m.from_items([{"x": 1}, {"x": 2}]).flat_map(apps.twice))
    _rows_equal(port, ref, any_order=True)
    port, ref = _both(lambda m: m.range(50).limit(7), lambda ds: ds.count())
    assert port == ref == 7
    port, ref = _both(lambda m: m.from_items(list(range(50))).limit(7))
    _rows_equal(port, ref)


def test_repartition_and_num_blocks(pool):
    for mod in (rd, rd_ref):
        ds = mod.range(100, parallelism=8).repartition(3).materialize()
        assert ds.num_blocks() == 3 and ds.count() == 100
    port, ref = _both(lambda m: m.from_items(list(range(100)), parallelism=8).repartition(3))
    _rows_equal(port, ref, any_order=True)


def test_one_output_block(pool):
    """The reference fails here (its one-part split returns a list under
    num_returns=1); the port gives one block of every row."""
    ds = rd.range(10, parallelism=3).repartition(1).materialize()
    assert ds.num_blocks() == 1 and sorted(r["id"] for r in ds.take_all()) == list(range(10))
    one = rd.from_items(list(range(10)), parallelism=1)
    assert sorted(r["item"] for r in one.random_shuffle(seed=1).take_all()) == list(range(10))
    assert [r["item"] for r in one.sort("item", descending=True).take_all()] == \
        list(range(9, -1, -1))


@pytest.mark.parametrize("layout", [(64, 4), (100, 7), (1000, 8)])
def test_random_shuffle_is_the_reference_order(pool, layout):
    n, parallelism = layout
    port, ref = _both(lambda m: m.from_items([{"id": i} for i in range(n)],
                                             parallelism=parallelism).random_shuffle(seed=0))
    _rows_equal(port, ref)
    assert sorted(r["id"] for r in port) == list(range(n))
    assert [r["id"] for r in port] != list(range(n))


def test_random_shuffle_of_mixed_columns(pool):
    rng = np.random.default_rng(5)
    rows = [{"id": i, "x": float(rng.normal()), "s": f"r{i}", "t": [i, i + 1]} for i in range(48)]
    port, ref = _both(lambda m: m.from_items(rows, parallelism=3).random_shuffle(seed=5))
    _rows_equal(port, ref)


@pytest.mark.parametrize("descending", [False, True])
def test_sort(pool, descending):
    values = np.random.default_rng(7).permutation(50)
    port, ref = _both(lambda m: m.from_items([{"v": int(v), "w": float(v) / 3}
                                              for v in values]).sort("v", descending=descending))
    _rows_equal(port, ref)
    out = [r["v"] for r in port]
    assert out == sorted(out, reverse=descending)


def _agg_rows_equal(port, ref):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        assert list(p) == list(r)
        for key in r:
            if isinstance(r[key], float):
                assert isinstance(p[key], float)
                assert p[key] == pytest.approx(r[key], rel=1e-12, abs=0), key
            else:
                assert _same(p[key], r[key]), (key, p[key], r[key])


@pytest.mark.parametrize("agg", ["count", "sum", "min", "max", "mean", "std"])
@pytest.mark.parametrize("keys", ["ints", "strings"])
def test_groupby_aggregate(pool, agg, keys):
    rng = np.random.default_rng(3)
    values = rng.normal(size=60)
    rows = [{"k": (i % 5) if keys == "ints" else f"key-{i % 5}", "v": float(values[i]),
             "n": int(i * 7 % 13)} for i in range(60)]

    def build(m):
        grouped = m.from_items(rows, parallelism=6).groupby("k")
        return grouped.count() if agg == "count" else getattr(grouped, agg)("v")

    port, ref = _both(build)
    _agg_rows_equal(port, ref)
    if agg in ("sum", "min", "max"):  # integer aggregates exactly
        port, ref = _both(lambda m: getattr(m.from_items(rows, parallelism=6).groupby("k"),
                                            agg)("n"))
        _rows_equal(port, ref)


def test_map_groups(pool):
    rows = [{"k": i % 4, "v": float(i)} for i in range(40)]
    port, ref = _both(lambda m: m.from_items(rows, parallelism=4).groupby("k").map_groups(
        apps.group_total))
    _rows_equal(port, ref, any_order=True)
    assert sorted((r["k"], r["total"]) for r in port) == [
        (k, float(sum(i for i in range(40) if i % 4 == k))) for k in range(4)]


def test_groupby_string_keys_cross_process(pool):
    rows = [{"k": f"key-{i % 5}", "v": 1.0} for i in range(40)]
    port, ref = _both(lambda m: m.from_items(rows, parallelism=8).groupby("k").sum("v"))
    _rows_equal(port, ref)
    assert {r["k"]: r["sum(v)"] for r in port} == {f"key-{i}": 8.0 for i in range(5)}


def test_global_aggregates(pool):
    port, ref = rd.range(10), rd_ref.range(10)
    for name in ("sum", "min", "max"):
        assert _same(getattr(port, name)("id"), getattr(ref, name)("id"))
    for name in ("mean", "std"):
        assert getattr(port, name)("id") == pytest.approx(getattr(ref, name)("id"), rel=1e-12)
    values = np.random.default_rng(11).normal(size=200)
    port = rd.from_items([{"x": float(v)} for v in values])
    ref = rd_ref.from_items([{"x": float(v)} for v in values])
    got = port.aggregate(rd.Sum("x"), rd.Mean("x"), rd.Std("x"), rd.Count())
    want = ref.aggregate(rd_ref.Sum("x"), rd_ref.Mean("x"), rd_ref.Std("x"), rd_ref.Count())
    assert list(got) == list(want) and got["count()"] == want["count()"] == 200
    for key in ("sum(x)", "mean(x)", "stddev(x)"):
        assert got[key] == pytest.approx(want[key], rel=1e-12)


def test_zip_and_union(pool):
    port, ref = _both(lambda m: m.from_items([{"a": i} for i in range(6)]).zip(
        m.from_items([{"b": i * 2} for i in range(6)])))
    _rows_equal(port, ref)
    assert all(r["b"] == r["a"] * 2 for r in port)
    port, ref = _both(lambda m: m.from_items([{"x": 1}]).union(m.from_items([{"x": 2}])))
    _rows_equal(port, ref)


def test_iter_batches_formats_and_sizes(pool):
    import torch

    port, ref = (m.from_items(list(range(100)), parallelism=5) for m in (rd, rd_ref))
    for drop_last in (False, True):
        got = list(port.iter_batches(batch_size=32, drop_last=drop_last))
        want = list(ref.iter_batches(batch_size=32, drop_last=drop_last))
        assert [len(b["item"]) for b in got] == [len(b["item"]) for b in want]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g["item"], w["item"])
            assert g["item"].dtype == w["item"].dtype
    sizes = [len(b["id"]) for b in rd.range(100, parallelism=5).iter_batches(batch_size=32)]
    assert sizes == [32, 32, 32, 4]
    pdf, rdf = (next(iter(ds.iter_batches(batch_size=10, batch_format="pandas")))
                for ds in (port, ref))
    assert pdf.equals(rdf)
    pat, rat = (next(iter(ds.iter_batches(batch_size=10, batch_format="pyarrow")))
                for ds in (port, ref))
    assert pat.equals(rat)
    tb, rb = (next(iter(ds.iter_torch_batches(batch_size=10))) for ds in (port, ref))
    assert isinstance(tb["item"], torch.Tensor) and torch.equal(tb["item"], rb["item"])
    shuffled = [list(ds.iter_batches(batch_size=16, local_shuffle_buffer_size=30,
                                     local_shuffle_seed=4))
                for ds in (m.from_items(list(range(100)), parallelism=5) for m in (rd, rd_ref))]
    assert len(shuffled[0]) == len(shuffled[1]) == 7
    for g, w in zip(*shuffled):
        np.testing.assert_array_equal(g["item"], w["item"])


def test_images_through_batches_are_exact(pool):
    """Tensor rows (fashion_mnist_rows' images) arrive bit for bit. The
    reference gives a batch cut from inside a block as nested Python floats
    (an object array: its ``_list_array_to_numpy`` reads a sliced
    fixed-size list's values from the slice's parent), so its values are
    held after conversion; the port's batches are float32 arrays."""
    from ray_tpu_torch.train.release_loops import fashion_mnist_rows

    port, ref = (m.range(300, parallelism=3).map_batches(fashion_mnist_rows,
                                                         fn_kwargs={"seed": 2})
                 for m in (rd, rd_ref))
    want = fashion_mnist_rows({"id": np.arange(300)}, seed=2)
    got = list(port.iter_batches(batch_size=64))
    ref_batches = list(ref.iter_batches(batch_size=64))
    assert len(got) == len(ref_batches) == 5
    for batches in (got, ref_batches):
        ids = np.concatenate([b["id"] for b in batches])
        assert sorted(ids.tolist()) == list(range(300))
        for b in batches:
            images = np.asarray(b["image"].tolist(), dtype=np.float32)
            np.testing.assert_array_equal(images, want["image"][b["id"]])
            np.testing.assert_array_equal(b["label"], want["label"][b["id"]])
    assert all(b["image"].dtype == np.float32 and b["image"].shape[1:] == (28, 28, 1)
               for b in got)


def test_select_drop_add_columns(pool):
    import pyarrow.compute as pc

    port = rd.from_items([{"a": 1, "b": 2, "c": 3}] * 4)
    ref = rd_ref.from_items([{"a": 1, "b": 2, "c": 3}] * 4)
    assert port.select_columns(["a", "b"]).columns() == \
        ref.select_columns(["a", "b"]).columns() == ["a", "b"]
    assert port.drop_columns(["c"]).columns() == ref.drop_columns(["c"]).columns()
    _rows_equal(port.add_column("d", apps.add_ab).take_all(),
                ref.add_column("d", lambda t: pc.add(t.column("a"), t.column("b"))).take_all())
    _rows_equal(rd.range(200, parallelism=4).random_sample(0.3, seed=9).take_all(),
                rd_ref.range(200, parallelism=4).random_sample(0.3, seed=9).take_all(),
                any_order=True)


def test_stats_and_schema(pool):
    ds = rd.range(1000, parallelism=4).map_batches(apps.identity)
    list(ds.iter_batches(batch_size=100))
    report = ds.stats()
    assert "operator" in report and "cpu" in report and "bytes" in report
    assert "Read" in report and "MapBatches" in report and "1000" in report
    assert "iterator:" in report and "wait" in report
    port, ref = (m.range(10).map_batches(apps.float_cols).materialize() for m in (rd, rd_ref))
    assert port.schema().names == list(ref.schema().names) == port.columns()
    assert port.schema().types == [ref.schema().field(n).type.to_pandas_dtype()
                                   for n in ref.schema().names]


def test_custom_datasource_and_datasink(pool):
    from ray_tpu.data.datasource import ReadTask as RefReadTask

    port = rd.read_datasource(apps.SquaresDatasource(100, rd.ReadTask), parallelism=4)
    ref = rd_ref.read_datasource(apps.SquaresDatasource(100, RefReadTask), parallelism=4)
    _rows_equal(port.take_all(), ref.take_all(), any_order=True)
    assert port.count() == 100 and port.sum("sq") == ref.sum("sq") == sum(i * i
                                                                            for i in range(100))
    sink = apps.CountingDatasink()
    port.write_datasink(sink)
    assert sink.started and sink.completed == 100


# ---------------------------------------------------------------- files
def _write(mod, fmt: str, path: str) -> None:
    # Blocks in a fixed order (no task stage before the write), so that
    # each part file holds the same rows in both packages.
    ds = mod.from_items([{"id": i, "s": str(i)} for i in range(25)], parallelism=2)
    if fmt == "tfrecords":
        ds = mod.from_items([{"id": i, "name": f"row-{i}", "score": float(i) / 2}
                             for i in range(30)])
    getattr(ds, f"write_{fmt}")(path)


def _read(mod, fmt: str, path: str) -> list:
    if fmt == "tfrecords":
        return sorted(mod.read_tfrecords(path + "/*.tfrecord").take_all(), key=lambda r: r["id"])
    return sorted(getattr(mod, f"read_{fmt}")(path).take_all(), key=lambda r: r["id"])


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("fmt", ["parquet", "csv", "json", "tfrecords"])
def test_files_written_by_one_package_read_by_the_other(pool, tmp_path, fmt, writer):
    path = str(tmp_path / fmt)
    _write(rd if writer == "port" else rd_ref, fmt, path)
    port, ref = _read(rd, fmt, path), _read(rd_ref, fmt, path)
    _rows_equal(port, ref)
    assert len(port) == (30 if fmt == "tfrecords" else 25)
    if fmt == "tfrecords":
        assert port[3]["name"] == b"row-3" and port[3]["score"] == 1.5


def test_files_written_by_both_packages_are_equal(pool, tmp_path):
    for fmt in ("csv", "json", "tfrecords"):
        _write(rd, fmt, str(tmp_path / f"port_{fmt}"))
        _write(rd_ref, fmt, str(tmp_path / f"ref_{fmt}"))
        names = sorted(os.listdir(tmp_path / f"ref_{fmt}"))
        assert sorted(os.listdir(tmp_path / f"port_{fmt}")) == names
        for name in names:
            assert (tmp_path / f"port_{fmt}" / name).read_bytes() == \
                (tmp_path / f"ref_{fmt}" / name).read_bytes(), (fmt, name)


def test_text_numpy_and_images(pool, tmp_path):
    from PIL import Image

    (tmp_path / "t.txt").write_text("alpha\nbeta\ngamma\n")
    np.save(tmp_path / "a.npy", np.arange(8).reshape(4, 2))
    for i in range(3):
        Image.new("RGB", (8, 8), color=(i * 20, 0, 0)).save(tmp_path / f"im{i}.png")
    for read in (lambda m: m.read_text(str(tmp_path / "t.txt")),
                 lambda m: m.read_numpy(str(tmp_path / "a.npy")),
                 lambda m: m.read_images(str(tmp_path / "im*.png"), size=(4, 4))):
        port, ref = _both(read)
        _rows_equal(port, ref, any_order=True)
    assert [r["text"] for r in rd.read_text(str(tmp_path / "t.txt")).take_all()] == \
        ["alpha", "beta", "gamma"]


# ---------------------------------------------------------------- refusals
def test_a_lambda_is_refused_with_the_rule(pool):
    with pytest.raises(TypeError, match="module level"):
        rd.range(10).map(lambda row: row).count()

    def local(row):
        return row

    with pytest.raises(TypeError, match="module level"):
        rd.range(10).map(local).count()


def test_a_failing_udf_raises_its_error(pool):
    with pytest.raises(local_tasks.TaskError, match="KeyError"):
        rd.from_items([{"x": 1}]).map(apps.double).take_all()


def test_a_dead_worker_fails_its_task_and_is_replaced(pool):
    with pytest.raises(local_tasks.WorkerCrashedError, match="exit code 3"):
        rd.from_items([{"id": 1}]).map_batches(apps.exit_now).take_all()
    assert rd.range(20, parallelism=4).map(apps.double).count() == 20
