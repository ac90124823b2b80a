"""The port keeps the JAX package's module names and public signatures.

Both packages are parsed with ``ast`` (nothing is imported). For every JAX
module that the port has, each public function, class and method of the
JAX module must exist in the port's module under the same name, with the
same positional parameters in the same order and the same keyword-only
parameters. The JAX ``ops/{dequant_matmul,decode_attention,
flash_attention,paged_attention}.py`` (the Pallas kernels) are the port's
``kernels/``. Names the port adds are free. The deliberate differences are
listed below, each with its reason; anything else fails.

The JAX package's ``scripts/`` are walked the same way: each ported script
(``block_transformer_tpu_torch/scripts/``, or the package's top level for
the entry points ported there) binds every public top-level name of its
JAX script and a ``main(argv=None)``; the scripts not ported yet are an
explicit set. Each ported script's command line takes every flag of its
JAX script's (``add_argument`` calls, read by ``ast``); the flags only the
port takes are listed by name.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "block_transformer_tpu"
PORT_PKG = ROOT / "block_transformer_tpu_torch"

# the Pallas kernels' modules live in the port's kernels/
MOVED = {f"ops/{n}.py": f"kernels/{n}.py" for n in (
    "dequant_matmul", "decode_attention", "flash_attention",
    "paged_attention")}

# ROADMAP Queue 1 item 5 (parallelism) is ported, both halves: no module
# and no name of the JAX package is left out as a gap
UNPORTED_MODULES = set()
QUEUE1_ITEM5_NAMES = {}
QUEUE1_ITEM5_PARAMS = {}
# orbax's abstract state tree: the port restores into a tree of tensors
# (``restore_checkpoint(..., like)``) and needs no abstract form
JAX_ONLY_NAMES = {"utils/checkpoint.py": {"abstract_like"}}
# the Pallas kernels' tile sizes and interpret mode: the hand kernels plan
# their own tiles, and the CPU runs each kernel's plain version
PALLAS_PARAMS = {"bm", "bn", "bk", "bq", "interpret"}
# jax.random keys become torch generators; JAX's orbax abstract state
# becomes the tree of tensors to restore into
RENAMED = {"key": {"gen", "generator"}, "abstract_state": {"like"}}
# parameters only the port has: the device each entry point allocates on
# (JAX places arrays on its default device), and a few options more
PORT_ONLY_PARAMS = {"device"}
PORT_ONLY_BY_NAME = {
    "generate": {"fresh_prefill"},      # generate_blocks' switch, passed on
    "gptq_quantize_block_transformer": {"stats"},   # seconds by trunk
    # the vanilla trainer's tensor-parallel stack comes in here, as the
    # block model's does through token_decoder_train_forward(stack_fn=):
    # JAX leaves the split to GSPMD
    "vanilla_forward": {"stack_fn"},
    "vanilla_loss": {"stack_fn"},
}


def _public(path: Path) -> dict:
    """{name: ast.arguments or None (a class)} of a module's top-level
    public functions and classes and their public methods (and
    ``__init__``), as ``Class.method``."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            out[node.name] = node.args
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out[node.name] = None
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef) and (
                        not sub.name.startswith("_") or sub.name == "__init__"):
                    out[f"{node.name}.{sub.name}"] = sub.args
    return out


def _params(args: ast.arguments, name: str, jax_side: bool):
    """(positional names in order, keyword-only names as a set), the
    deliberate differences taken out."""
    fn = name.split(".")[-1]
    if jax_side:
        drop = PALLAS_PARAMS | QUEUE1_ITEM5_PARAMS.get(fn, set())
    else:
        drop = PORT_ONLY_PARAMS | PORT_ONLY_BY_NAME.get(fn, set())

    def norm(a):
        if not jax_side:
            for jax_name, port_names in RENAMED.items():
                if a in port_names:
                    return jax_name
        return a

    pos = [norm(a.arg) for a in args.posonlyargs + args.args
           if a.arg not in drop]
    kw = {norm(a.arg) for a in args.kwonlyargs if a.arg not in drop}
    return pos, kw, args.vararg is not None, args.kwarg is not None


def _jax_modules():
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def test_every_unported_module_is_a_listed_gap():
    missing = {m for m in _jax_modules()
               if not (PORT_PKG / MOVED.get(m, m)).exists()}
    assert missing == UNPORTED_MODULES


PORTED = [m for m in _jax_modules() if m not in UNPORTED_MODULES]


@pytest.mark.parametrize("module", PORTED)
def test_public_names_and_parameters_match_jax(module):
    want = _public(JAX_PKG / module)
    got = _public(PORT_PKG / MOVED.get(module, module))
    skip = QUEUE1_ITEM5_NAMES.get(module, set()) | JAX_ONLY_NAMES.get(
        module, set())
    faults = []
    for name, args in want.items():
        if name in skip:
            if name in got:
                faults.append(f"{name} is listed as a gap but is ported")
            continue
        if name not in got:
            faults.append(f"{name} is missing")
        elif (args is None) != (got[name] is None):
            faults.append(f"{name}: a class on one side only")
        elif args is not None:
            j, p = _params(args, name, True), _params(got[name], name, False)
            if j != p:
                faults.append(f"{name}: JAX {j}, port {p}")
    assert not faults, f"{module}: " + "; ".join(faults)


# ---------------------------------------------------------------------------
# scripts/: each JAX script beside its port
# ---------------------------------------------------------------------------

JAX_SCRIPTS = ROOT / "scripts"
PORT_SCRIPTS = PORT_PKG / "scripts"
# the JAX scripts whose port sits at the package's top level
TOP_LEVEL_SCRIPTS = {"pretrain_block_transformer.py",
                     "pretrain_vanilla_transformer.py",
                     "eval_zero_shot_task.py", "eval_longctx.py",
                     "export_checkpoint.py"}
# the repository's documentation linter (tests/test_doc_lint.py runs it):
# a tool of the repository, not of the system, so it has no port
REPO_TOOLS = {"doc_lint.py"}
# every script of the JAX package is ported (ROADMAP Queue 1 item 6 closed
# with the ten speed probes); the JAX benchmark ``bench.py`` (the repository's
# root, not scripts/) is ported as ``block_transformer_tpu_torch/bench.py``
# and held by the cases at the end of this file
UNPORTED_SCRIPTS = set()
# the JAX decode gates decode each variant in a subprocess (its WORKER
# source and the npz its trees travel in); the port runs them in-process
SCRIPT_ONLY_NAMES = {"decode_gate.py": {"WORKER", "save_tree_npz"},
                     "w8a8_decode_gate.py": {"WORKER"}}


def _script_names(path: Path, with_imports: bool) -> set:
    """The public names a script binds at its top level: functions,
    classes, assigned names and (``with_imports``) names imported from a
    module."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.ImportFrom) and with_imports:
            out |= {a.asname or a.name for a in node.names}
    return {n for n in out if not n.startswith("_")}


def _port_script(name: str) -> Path:
    return PORT_PKG / name if name in TOP_LEVEL_SCRIPTS else \
        PORT_SCRIPTS / name


def test_every_unported_script_is_a_listed_gap():
    scripts = {p.name for p in JAX_SCRIPTS.glob("*.py")}
    missing = {s for s in scripts - REPO_TOOLS if not _port_script(s).exists()}
    assert missing == UNPORTED_SCRIPTS
    # and the port has no script the JAX package lacks
    assert {p.name for p in PORT_SCRIPTS.glob("*.py")} - {"__init__.py"} \
        <= scripts


PORTED_SCRIPTS = sorted({p.name for p in JAX_SCRIPTS.glob("*.py")}
                        - REPO_TOOLS - UNPORTED_SCRIPTS)


@pytest.mark.parametrize("script", PORTED_SCRIPTS)
def test_script_public_names_and_main_match_jax(script):
    want = _script_names(JAX_SCRIPTS / script, False) - SCRIPT_ONLY_NAMES.get(
        script, set())
    got = _script_names(_port_script(script), True)
    assert "main" in want and "main" in got
    assert not want - got, f"{script}: missing {sorted(want - got)}"
    tree = ast.parse(_port_script(script).read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
                and n.name == "main")
    assert [a.arg for a in main.args.args] == ["argv"], script
    assert [ast.literal_eval(d) for d in main.args.defaults] == [None]


# flags only the port's scripts take: ``--cpu`` (the port runs on the card
# unless asked; the JAX scripts pick the device with JAX's platform, and
# inference_demo / measure_generation_time read --cpu from sys.argv), and
# per script the JAX script's inputs that the port made flags
PORT_ONLY_FLAGS = {"--cpu"}
PORT_ONLY_FLAGS_BY_SCRIPT = {
    # JAX's fixes these at the quality run's layout; the port takes them
    "longctx_quality_cpu.py": {"--context_length", "--corpus", "--haystack",
                               "--out"},
}
# the port's helpers that add flags to a parser (name -> its module)
FLAG_HELPERS = {"add_ignored_optimizer_flags": PORT_SCRIPTS / "quality_run.py"}
# the scripts that take --lr / --steps and ignore them, with the reason in
# their help: JAX rebuilds the optimizer state a checkpoint is restored
# into, the port restores the parameters alone (restore_params)
IGNORED_OPTIMIZER_FLAGS = ["decode_gate", "gptq_gate", "kv_quality_cpu",
                           "real_task_eval", "w8a8_decode_gate"]


def _add_argument_flags(tree) -> set:
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute) and node.func.attr == "add_argument":
            out |= {a.value for a in node.args if isinstance(a, ast.Constant)
                    and isinstance(a.value, str) and a.value.startswith("-")}
    return out


def _helper_flags(name: str) -> set:
    tree = ast.parse(FLAG_HELPERS[name].read_text())
    return _add_argument_flags(next(
        n for n in tree.body if isinstance(n, ast.FunctionDef)
        and n.name == name))


def _flags(path: Path) -> set:
    """The option strings of every ``add_argument`` call in ``path``, and
    of every ``FLAG_HELPERS`` helper it calls."""
    tree = ast.parse(path.read_text())
    out = _add_argument_flags(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in FLAG_HELPERS:
            out |= _helper_flags(node.func.id)
    return out


@pytest.mark.parametrize("script", PORTED_SCRIPTS)
def test_script_takes_every_jax_flag(script):
    want = _flags(JAX_SCRIPTS / script)
    got = _flags(_port_script(script))
    assert not want - got, f"{script}: missing {sorted(want - got)}"
    extra = got - want - PORT_ONLY_FLAGS
    assert extra == PORT_ONLY_FLAGS_BY_SCRIPT.get(script, set()), \
        f"{script}: port-only flags {sorted(extra)}"


def test_the_flag_walk_catches_a_missing_flag(tmp_path):
    jax_like = tmp_path / "jax.py"
    jax_like.write_text("ap.add_argument('--lr', type=float)\n"
                        "ap.add_argument('--steps', type=int)\n")
    port_like = tmp_path / "port.py"
    port_like.write_text("ap.add_argument('--steps', type=int)\n")
    assert _flags(jax_like) - _flags(port_like) == {"--lr"}
    port_like.write_text("add_ignored_optimizer_flags(ap, steps=3)\n")
    assert _flags(jax_like) <= _flags(port_like)


@pytest.mark.parametrize("script", IGNORED_OPTIMIZER_FLAGS)
def test_a_jax_command_line_with_lr_and_steps_parses(script, capsys):
    """The repaired scripts take JAX's ``--lr`` / ``--steps`` (argparse
    itself, through ``--help``, which exits before any work), and their
    help says why they are ignored."""
    import importlib
    module = importlib.import_module(
        f"block_transformer_tpu_torch.scripts.{script}")
    with pytest.raises(SystemExit) as exit_:
        module.main(["--lr", "3e-4", "--steps", "5000", "--help"])
    assert exit_.value.code == 0
    help_text = " ".join(capsys.readouterr().out.split())
    assert "--lr LR" in help_text and "--steps STEPS" in help_text
    assert "ignored" in help_text and "restore_params" in help_text


# ---------------------------------------------------------------------------
# bench.py: the JAX benchmark beside block_transformer_tpu_torch/bench.py
# ---------------------------------------------------------------------------

JAX_BENCH = ROOT / "bench.py"
PORT_BENCH = PORT_PKG / "bench.py"
# the benchmark's private helpers that the port keeps under their names
BENCH_PRIVATE = ("_quant_kwargs", "_two_level_decomposition")


def _bench_functions(path: Path) -> dict:
    return {n.name: n.args for n in ast.parse(path.read_text()).body
            if isinstance(n, ast.FunctionDef)}


def test_bench_names_and_parameters_match_jax():
    """Every public function of ``bench.py`` but ``main`` (and the helpers
    ``BENCH_PRIVATE``) in the port's benchmark, with the same parameters;
    ``device`` is the port's only extra one."""
    want, got = _bench_functions(JAX_BENCH), _bench_functions(PORT_BENCH)
    names = [n for n in want if not n.startswith("_") and n != "main"]
    assert names and set(names) <= set(_public(JAX_BENCH))
    faults = []
    for name in names + list(BENCH_PRIVATE):
        if name not in got:
            faults.append(f"{name} is missing")
            continue
        j, p = _params(want[name], name, True), _params(got[name], name,
                                                        False)
        if j != p:
            faults.append(f"{name}: JAX {j}, port {p}")
    assert not faults, "; ".join(faults)


def test_bench_main_takes_argv():
    main = _bench_functions(PORT_BENCH)["main"]
    assert [a.arg for a in main.args] == ["argv"]
    assert [ast.literal_eval(d) for d in main.defaults] == [None]
    assert not main.kwonlyargs and not main.vararg and not main.kwarg


def test_bench_takes_every_jax_flag():
    want, got = _flags(JAX_BENCH), _flags(PORT_BENCH)
    assert "--detail_out" in want and not want - got, sorted(want - got)
    assert got - want == PORT_ONLY_FLAGS
