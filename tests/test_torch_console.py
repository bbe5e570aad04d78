"""The port's console (hyrise_tpu_torch/console.py) against the JAX
package's (hyrise_tpu/console.py): the same command scripts through both,
whose outputs must be equal once timings are taken out. The port's console
works on an explicit Catalog and its TransactionManager; the JAX console on
its process-wide defaults, which each test resets."""

import io
import re
import tempfile

import pytest

from hyrise_tpu.concurrency.transaction import reset_default_transaction_manager
from hyrise_tpu.console import Console as JaxConsole
from hyrise_tpu.storage.catalog import reset_default_catalog
from hyrise_tpu_torch.console import Console, checked_device, main as console_main
from hyrise_tpu_torch.storage.catalog import Catalog

TIMINGS = re.compile(r"\(\d+\.\d+ms\)|in \d+\.\d+s")


@pytest.fixture()
def consoles():
    reset_default_catalog()
    reset_default_transaction_manager()
    out, jax_out = io.StringIO(), io.StringIO()
    yield Console(Catalog(device="cpu"), out=out), JaxConsole(out=jax_out)
    reset_default_catalog()
    reset_default_transaction_manager()


def run(console, lines):
    """The console's output for each line, timings taken out; False where
    the console asked to exit."""
    out = []
    for line in lines:
        start = console.out.tell()
        going = console.handle(line)
        out.append(TIMINGS.sub("(time)", console.out.getvalue()[start:]))
        if not going:
            out.append(False)
            break
    return out


def same_output(consoles, lines):
    port, jax = consoles
    got, want = run(port, lines), run(jax, lines)
    for line, g, w in zip(lines, got, want):
        assert g == w, f"{line!r}:\n{g}\n---- JAX ----\n{w}"
    assert len(got) == len(want)
    return got


def test_commands_and_transactions(consoles):
    out = same_output(consoles, [
        "help", "txinfo", "setting mvcc off", "setting mvcc on", "setting nonsense",
        ".nonsense",
        "CREATE TABLE acct (id INT, bal DOUBLE, owner TEXT)",
        "INSERT INTO acct VALUES (1, 10.5, 'ann'), (2, 20.25, 'bob'), (3, 0.0, NULL)",
        "SELECT * FROM acct ORDER BY id",
        "begin", "begin", "txinfo",
        "UPDATE acct SET bal = bal + 1.0 WHERE id = 1",
        "SELECT id, bal FROM acct ORDER BY id",
        "rollback",
        "SELECT id, bal FROM acct ORDER BY id",
        "begin", "DELETE FROM acct WHERE id = 2", "commit",
        "SELECT * FROM acct ORDER BY id",
        "commit", "rollback",
        "SELECT owner, COUNT(*) FROM acct GROUP BY owner ORDER BY owner",
        "quit", "help",
    ])
    assert out[-1] is False  # quit ends the console; the last line never runs
    assert "rolled back\n" in out and "error: " not in "".join(out[:-1])


def test_generate_and_query(consoles):
    same_output(consoles, [
        "generate tpch 0.01",
        "SELECT n_name, r_name FROM nation JOIN region ON n_regionkey = r_regionkey "
        "WHERE r_name = 'ASIA' ORDER BY n_name",
        "SELECT l_returnflag, l_linestatus, COUNT(*), SUM(l_quantity) FROM lineitem "
        "GROUP BY l_returnflag, l_linestatus ORDER BY l_returnflag, l_linestatus",
        "generate tpcc 1",
        "SELECT COUNT(*) FROM warehouse",
        "SELECT d_id, d_name, d_tax FROM district ORDER BY d_id LIMIT 3",
        "SELECT c_credit, COUNT(*) FROM customer GROUP BY c_credit ORDER BY c_credit",
        "print warehouse",
    ])
    port, _ = consoles
    for name in ("lineitem", "stock"):
        assert port.catalog.get_table(name).device.type == "cpu"


def test_load_and_script(consoles, tmp_path):
    tbl = tmp_path / "pets.tbl"
    tbl.write_text("id|name|w\nint|string|float_null\n1|rex|3.5\n2|tom|null\n3|kit|1.25\n")
    script = tmp_path / "script.sql"
    script.write_text(f"load {tbl}\nSELECT name, w FROM pets ORDER BY id\nquit\n"
                      "SELECT 1\n")
    same_output(consoles, [f"load {tbl} pets2", "print pets2", f"script {script}",
                           "SELECT COUNT(*) FROM pets"])


def test_visualize_writes_the_plan(consoles, tmp_path, monkeypatch):
    from hyrise_tpu_torch.utils import visualize
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(visualize.shutil, "which", lambda name: None)
    port, _ = consoles
    port.handle("CREATE TABLE v (a INT)")
    for kind in ("lqp", "pqp"):
        port.handle(f"visualize {kind} SELECT a FROM v WHERE a > 1")
        path = tmp_path / f"hyrise_tpu_torch_{kind}.dot"
        assert f"wrote {path}" in port.out.getvalue()
        assert path.read_text().startswith(f"digraph {kind.upper()} {{")


def test_console_uses_its_catalogs_transactions():
    cat = Catalog(device="cpu")
    console = Console(cat, out=io.StringIO())
    assert console.tm is cat.transaction_manager
    console.handle("CREATE TABLE x (a INT)")
    console.handle("begin")
    console.handle("INSERT INTO x VALUES (1)")
    # another session on the same catalog does not see the open insert
    other = Console(cat, out=io.StringIO())
    other.handle("SELECT COUNT(*) FROM x")
    assert "|        0 |" in other.out.getvalue()
    console.handle("commit")
    other.handle("SELECT COUNT(*) FROM x")
    assert "|        1 |" in other.out.getvalue()


def test_entry_point_needs_a_card_unless_told_cpu():
    import torch
    assert checked_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        checked_device("cuda")
    with pytest.raises(RuntimeError, match="--device cpu"):
        console_main([])
