"""Interactive SQL console.

Port of hyrise_tpu/console.py (reference: src/bin/console/console.cpp: a
readline REPL with the commands generate, load, script, print, visualize,
begin / rollback / commit, txinfo, setting, help and exit, and SQL through
the SQLPipeline with explicit transactions). The port has no default
catalog: a Console works on the Catalog it is given, and on that catalog's
TransactionManager. Tables it generates or loads go to the catalog's
device.

    python -m hyrise_tpu_torch.console [--device cuda|cpu]

starts it on the card (the default; it raises where there is none), or on
the CPU with --device cpu.
"""

from __future__ import annotations

import os
import shlex
import sys
import tempfile
import time

import torch

from hyrise_tpu_torch.ops.print_op import format_table
from hyrise_tpu_torch.sql.pipeline import SQLPipelineBuilder
from hyrise_tpu_torch.storage.catalog import Catalog


class Console:
    PROMPT = "> "

    def __init__(self, catalog: Catalog, out=None):
        self.catalog = catalog
        self.tm = catalog.transaction_manager
        self.context = None
        self.out = out or sys.stdout
        # MVCC validation on by default, like the reference console:
        # otherwise deleted rows stay visible
        self.use_mvcc = True
        self.prepared: dict = {}  # this session's SQL PREPARE statements

    def println(self, *a):
        print(*a, file=self.out)

    # -- command dispatch ----------------------------------------------------

    def handle(self, line: str) -> bool:
        """Returns False when the console should exit."""
        line = line.strip()
        if not line:
            return True
        if line.startswith("."):  # dot-commands, as the reference has them
            return self._command(line[1:])
        for word, fn in (("generate", self._cmd_generate),
                         ("load", self._cmd_load),
                         ("script", self._cmd_script),
                         ("print", self._cmd_print),
                         ("visualize", self._cmd_visualize),
                         ("begin", self._cmd_begin),
                         ("rollback", self._cmd_rollback),
                         ("commit", self._cmd_commit),
                         ("txinfo", self._cmd_txinfo),
                         ("setting", self._cmd_setting),
                         ("help", self._cmd_help),
                         ("quit", None), ("exit", None)):
            if line.lower() == word or line.lower().startswith(word + " "):
                if fn is None:
                    return False
                fn(line[len(word):].strip())
                return True
        self._run_sql(line)
        return True

    def _command(self, cmd: str) -> bool:
        if cmd in ("quit", "exit"):
            return False
        self.println(f"unknown command .{cmd}")
        return True

    def _replace(self, name: str, table) -> None:
        if self.catalog.has_table(name):
            self.catalog.drop_table(name)
        self.catalog.add_table(name, table)

    # -- commands ------------------------------------------------------------

    def _cmd_generate(self, arg: str):
        """generate [tpch|tpcc] [scale_factor | warehouses]"""
        parts = arg.split()
        kind = parts[0] if parts else "tpch"
        sf = float(parts[1]) if len(parts) > 1 else 0.01
        t0 = time.time()
        device = self.catalog.device
        if kind == "tpcc":
            from hyrise_tpu_torch.tpcc.generator import generate_tpcc_tables
            tables = generate_tpcc_tables(max(int(sf), 1), device=device)
        else:
            from hyrise_tpu_torch.tpch.dbgen import generate_tables
            tables = generate_tables(sf, device=device)
        for name, t in tables.items():
            self._replace(name, t)
        self.println(f"generated {len(tables)} {kind} tables "
                     f"(sf={sf}) in {time.time() - t0:.1f}s")

    def _cmd_load(self, arg: str):
        """load FILE [NAME] — .tbl / .csv / .npz"""
        parts = shlex.split(arg)
        path = parts[0]
        name = parts[1] if len(parts) > 1 else path.rsplit("/", 1)[-1] \
            .split(".")[0]
        device = self.catalog.device
        if path.endswith(".tbl"):
            from hyrise_tpu_torch.storage.load_table import load_table
            t = load_table(path, name, device=device)
        elif path.endswith(".csv"):
            from hyrise_tpu_torch.ops.import_export import load_csv
            t = load_csv(path, name, device=device)
        else:
            from hyrise_tpu_torch.ops.import_export import load_binary
            t = load_binary(path, name, device=device)
        self._replace(name, t)
        self.println(f"loaded {name}: {t.num_rows} rows")

    def _cmd_script(self, arg: str):
        with open(arg) as f:
            for line in f:
                if not self.handle(line.rstrip("\n")):
                    break

    def _cmd_print(self, arg: str):
        t = self.catalog.get_table(arg)
        self.println(format_table(t))

    def _cmd_visualize(self, arg: str):
        """visualize [lqp|pqp] SQL — writes the plan's graph to the
        temporary directory."""
        from hyrise_tpu_torch.plan.optimizer import Optimizer
        from hyrise_tpu_torch.plan.translator import translate_lqp
        from hyrise_tpu_torch.sql.parser import parse_sql
        from hyrise_tpu_torch.sql.translator import SQLToLQPTranslator
        from hyrise_tpu_torch.utils.visualize import lqp_to_dot, pqp_to_dot, render_dot

        parts = arg.split(None, 1)
        kind = "lqp"
        sql = arg
        if parts and parts[0] in ("lqp", "pqp"):
            kind, sql = parts[0], parts[1]
        stmt = parse_sql(sql)[0]
        lqp = SQLToLQPTranslator(self.catalog).translate(stmt)
        lqp = Optimizer().optimize(lqp, self.catalog)
        if kind == "lqp":
            dot = lqp_to_dot(lqp)
        else:
            dot = pqp_to_dot(translate_lqp(lqp, self.catalog))
        path = render_dot(dot, os.path.join(tempfile.gettempdir(),
                                            f"hyrise_tpu_torch_{kind}"))
        self.println(f"wrote {path}")

    def _cmd_begin(self, arg: str):
        if self.context is not None:
            self.println("already in a transaction")
            return
        self.context = self.tm.new_transaction_context()
        self.println(f"transaction {int(self.context.transaction_id)} started")

    def _cmd_rollback(self, arg: str):
        if self.context is None:
            self.println("no open transaction")
            return
        self.context.rollback()
        self.context = None
        self.println("rolled back")

    def _cmd_commit(self, arg: str):
        if self.context is None:
            self.println("no open transaction")
            return
        self.context.commit()
        self.println(f"committed at cid {int(self.context.commit_id)}")
        self.context = None

    def _cmd_txinfo(self, arg: str):
        if self.context is None:
            self.println("auto-commit mode (no explicit transaction)")
        else:
            c = self.context
            self.println(f"tid={int(c.transaction_id)} "
                         f"snapshot_cid={int(c.snapshot_commit_id)} "
                         f"phase={c.phase.value}")

    def _cmd_setting(self, arg: str):
        parts = arg.split()
        if len(parts) == 2 and parts[0] == "mvcc":
            self.use_mvcc = parts[1] in ("on", "true", "1")
            self.println(f"mvcc = {self.use_mvcc}")
            return
        self.println("settings: mvcc on|off")

    def _cmd_help(self, arg: str):
        self.println("""commands:
  generate [tpch|tpcc] [sf]   generate benchmark tables
  load FILE [NAME]            load .tbl/.csv/.npz into the catalog
  script FILE                 run commands from a file
  print TABLE                 dump a table
  visualize [lqp|pqp] SQL     write a plan graph (graphviz)
  begin / commit / rollback   explicit transactions
  txinfo                      show transaction state
  setting mvcc on|off         toggle MVCC validation
  help, quit                  this help / exit
anything else is executed as SQL""")

    # -- SQL -----------------------------------------------------------------

    def _run_sql(self, sql: str):
        t0 = time.time()
        try:
            b = SQLPipelineBuilder(sql).with_catalog(self.catalog) \
                .with_transaction_manager(self.tm).with_prepared(self.prepared)
            if self.use_mvcc:
                b.with_mvcc(True)
            if self.context is not None:
                b.with_transaction_context(self.context)
            result = b.create_pipeline().get_result_table()
            self.println(format_table(result))
            self.println(f"({(time.time() - t0) * 1e3:.1f}ms)")
        except Exception as e:  # the session goes on after a failed statement
            self.println(f"error: {e}")

    def repl(self):
        self.println("hyrise_tpu_torch console — 'help' for commands")
        while True:
            try:
                line = input(self.PROMPT)
            except (EOFError, KeyboardInterrupt):
                break
            if not self.handle(line):
                break


def checked_device(name: str) -> torch.device:
    """The device an entry point runs on: 'cuda' must have a card."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    return device


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="hyrise_tpu_torch SQL console")
    p.add_argument("--device", default="cuda",
                   help="where tables are generated and loaded (cuda or cpu)")
    args = p.parse_args(argv)
    Console(Catalog(device=checked_device(args.device))).repl()


if __name__ == "__main__":
    main()
