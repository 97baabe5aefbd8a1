"""qst_tpu_torch's public surface against qst_tpu's, read from the source.

Both trees are parsed with ``ast``; neither package is imported (but for the
last case, which imports the port in a fresh interpreter). For every module
``qst_tpu/<rel>`` the port must have ``qst_tpu_torch/<rel>`` (the four
``ops/*_pallas.py`` kernels map to the wrappers of their CUDA kernels), and
in it:

- every public top-level function and class of the JAX module, and every
  public method of such a class, ``__init__`` and ``__call__`` included (a
  dataclass's or Flax module's fields are its ``__init__``'s arguments; an
  ``nn.Module``'s ``forward`` answers for ``__call__``; a port class's
  methods include those of its bases in the port);
- every argument name of each such function or method;
- every name of a package ``__init__``'s ``__all__``, in the counterpart's
  ``__all__``;
- every ``--flag`` of a ``qst_tpu/cli/*.py`` (``add_argument``,
  ``add_bool_flag`` and the ``cli/common.py`` helpers that add flags).

What the port does differently on purpose is one table, ``EXCEPTIONS``:
each row names the JAX symbol, what takes its place in the port (or "not
carried") and why.
"""

import ast
import os
import shutil
import subprocess
import sys
import textwrap
from typing import Dict, List, NamedTuple, Optional, Set, Tuple

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "qst_tpu")
PORT_ROOT = os.path.join(REPO, "qst_tpu_torch")

# the Pallas kernels' modules → the modules that wrap their CUDA kernels
FILE_MAP = {
    "ops/fused_layer_pallas.py": "ops/fused_layer.py",
    "ops/quadruplet_pallas.py": "ops/quadruplet.py",
    "ops/topk_pallas.py": "ops/topk.py",
    "ops/ivf_pallas.py": "ops/ivf.py",
}


class Exception_(NamedTuple):
    symbol: str          # as the checker reports it: "rel:name", "rel:Cls.meth(arg)", ...
    port: str            # what takes its place in the port, or "not carried"
    reason: str


NOT_CARRIED = "not carried"
_RNG = "a torch.Generator replaces the JAX PRNG key"
_TX = "the port's optimizer object (ClippedAdamW) replaces the optax transformation"
_PARAMS = "the port passes nn.Modules and state dicts where qst_tpu passes Flax param trees"
_INTERPRET = ("Pallas interpret mode: a port wrapper takes its plain PyTorch version for CPU "
              "tensors and launches the CUDA kernel for CUDA tensors")
_TILES = "a Mosaic tiling argument of the TPU kernel; the CUDA kernel picks its own tiles"
_NB = ("the sequences a grid step of the TPU kernel; the CUDA kernel needs no batch blocking, "
       "and the config's fused_nb keeps the dropout masks' bits")
_SETUP = "Flax's setup(); an nn.Module builds its submodules in __init__"
_DETERMINISTIC = ("dropout runs in an nn.Module's train() mode, from its dropout_generator, "
                  "in place of Flax's deterministic flag")
_ROADMAP = "exists only for the TPU dev relay or Mosaic's limits (ROADMAP.md, code not carried)"

EXCEPTIONS: Tuple[Exception_, ...] = (
    # idiom renames: rng / key → generator
    Exception_("models/sentence_encoder.py:init_params(rng)", "generator", _RNG),
    Exception_("models/cross_encoder.py:init_cross_encoder(rng)", "generator", _RNG),
    Exception_("models/discriminator.py:init_discriminator(rng)", "generator", _RNG),
    Exception_("models/mlm.py:init_mlm_params(rng)", "generator", _RNG),
    Exception_("models/seq2seq.py:init_seq2seq(rng)", "generator", _RNG),
    Exception_("train/train_step.py:create_train_state(rng)", "generator", _RNG),
    Exception_("train/train_step.py:create_train_state_sharded(rng)", "generator", _RNG),
    Exception_("train/trainer.py:Trainer.train(rng)", "generator", _RNG),
    Exception_("data/mining.py:mine_negatives(key)", "generator", _RNG),
    Exception_("retrieval/ivf.py:kmeans(key)", "generator", _RNG),
    Exception_("retrieval/pq.py:pq_train(key)", "generator", _RNG),
    Exception_("retrieval/pq4.py:pq4_train(key)", "generator", _RNG),
    Exception_("retrieval/ivfpq.py:pq_train_raw(key)", "generator", _RNG),
    Exception_("core/rng.py:RngStream.__init__(key)", "RngStream(seed)",
               "the stream is seeded by an int and hands out torch.Generators"),
    Exception_("ops/fused_layer_pallas.py:fused_encoder_forward(dropout_rng)", "dropout_key",
               "the fused path's dropout draws from a (seed, step) tensor, as K1 does"),
    # tx → optimizer
    Exception_("train/train_step.py:make_train_step(tx)", "state.optimizer", _TX),
    Exception_("train/train_step.py:make_multi_step(tx)", "state.optimizer", _TX),
    Exception_("parallel/pipeline.py:make_pp_train_step(tx)", "state.optimizer", _TX),
    # params → state_dict / model
    Exception_("models/hf_export.py:export_state_dict(params)", "state_dict", _PARAMS),
    Exception_("models/hf_export.py:save_torch_state_dict(params)", "state_dict", _PARAMS),
    Exception_("evals/loss_evaluator.py:QuadrupletLossEvaluator.__call__(params)", "model",
               _PARAMS),
    Exception_("evals/loss_evaluator.py:QuadrupletLossEvaluator.__call__(discr_params)",
               "discriminator", _PARAMS),
    Exception_("models/hf_export.py:export_bert_state_dict(params)", "state_dict", _PARAMS),
    Exception_("models/hf_export.py:export_mpnet_state_dict(params)", "state_dict", _PARAMS),
    Exception_("ops/fused_layer_pallas.py:fused_encoder_forward(params)", "model", _PARAMS),
    Exception_("ops/fused_layer_pallas.py:layer_weights_from_params",
               "ops/fused_layer.py:layer_weights_from_module", _PARAMS),
    Exception_("models/sentence_encoder.py:init_params(batch)", NOT_CARRIED,
               "Flax traces a forward on a dummy batch to shape the params; a module knows "
               "its shapes"),
    # Flax's deterministic flag → nn.Module.train() / eval()
    *(Exception_(f"models/{m}.__call__(deterministic)", "module.train() / module.eval()",
                 _DETERMINISTIC)
      for m in ("bert.py:BertEmbeddings", "bert.py:BertSelfAttention", "bert.py:BertLayer",
                "bert.py:BertEncoder", "mpnet.py:MPNetAttention", "mpnet.py:MPNetLayer",
                "mpnet.py:MPNetEncoder", "sentence_encoder.py:SentenceEncoderModule",
                "cross_encoder.py:CrossEncoderModule", "mlm.py:BertMLMModule")),
    Exception_("models/bert.py:BertSelfAttention.__call__(attention_bias)", "bias",
               "one additive (B, 1, 1, S) bias, the name the fused layer gives it"),
    Exception_("models/bert.py:BertLayer.__call__(attention_bias)", "bias",
               "one additive (B, 1, 1, S) bias, the name the fused layer gives it"),
    # TrainState's fields
    Exception_("train/train_step.py:TrainState.__init__(params)", "model", _PARAMS),
    Exception_("train/train_step.py:TrainState.__init__(opt_state)", "optimizer",
               "the optimizer object holds its own moments"),
    Exception_("train/train_step.py:TrainState.__init__(discr_params)", "discriminator",
               _PARAMS),
    # MarianDecoderLayer.step's cache
    Exception_("models/seq2seq.py:MarianDecoderLayer.step(cache)", "self_kv, cross_kv",
               "the KV cache is two stacked (2, B, nh, L, hd) tensors, not a dict"),
    Exception_("models/seq2seq.py:MarianDecoderLayer.step(self_bias)", NOT_CARRIED,
               "the self-attention step attends over the filled slots 0..t, so it needs no "
               "bias"),
    Exception_("parallel/sharding.py:spec_for_param(path_str)", "name",
               "the rules match a state dict's tensor name, not a Flax tree path"),
    # Flax setup
    Exception_("models/seq2seq.py:MarianAttention.setup", "__init__", _SETUP),
    Exception_("models/seq2seq.py:MarianDecoderLayer.setup", "__init__", _SETUP),
    Exception_("models/seq2seq.py:MarianModule.setup", "__init__", _SETUP),
    # the Pallas kernels' own arguments
    Exception_("ops/fused_layer_pallas.py:fused_bert_layer(interpret)", NOT_CARRIED,
               _INTERPRET),
    Exception_("ops/fused_layer_pallas.py:fused_encoder_forward(interpret)", NOT_CARRIED,
               _INTERPRET),
    Exception_("ops/fused_layer_pallas.py:fused_embed_fn(interpret)", NOT_CARRIED, _INTERPRET),
    Exception_("ops/quadruplet_pallas.py:fused_gamma_quadruplet_loss(interpret)", NOT_CARRIED,
               _INTERPRET),
    Exception_("ops/topk_pallas.py:bucket_maxima(interpret)", NOT_CARRIED, _INTERPRET),
    Exception_("ops/topk_pallas.py:rescore_buckets(interpret)", NOT_CARRIED, _INTERPRET),
    Exception_("ops/fused_layer_pallas.py:fused_encoder_forward(nb)", "EncoderConfig.fused_nb",
               _NB),
    Exception_("ops/fused_layer_pallas.py:fused_embed_fn(nb)", "EncoderConfig.fused_nb", _NB),
    Exception_("ops/topk_pallas.py:bucket_maxima(corpus_outer)", NOT_CARRIED, _TILES),
    Exception_("ops/topk_pallas.py:bucket_maxima(qb2)", NOT_CARRIED, _TILES),
    Exception_("ops/topk_pallas.py:bucket_maxima(cb2)", NOT_CARRIED, _TILES),
    Exception_("ops/topk_pallas.py:rescore_buckets(corpus_padded)", NOT_CARRIED,
               "the corpus padded to whole buckets; the CUDA kernel reads the rows it has"),
    Exception_("ops/topk_pallas.py:pallas_topk_local", "ops/topk.py:topk_local",
               "the port's kernel wrappers are not named after Pallas"),
    Exception_("ops/topk_pallas.py:pallas_topk_v2", "ops/topk.py:topk_v2",
               "the port's kernel wrappers are not named after Pallas"),
    Exception_("ops/ivf_pallas.py:ivf_cell_scores_fn", "ops/ivf.py:ivf_cell_scores",
               "a function to call, not a factory of a jitted one"),
    # the code ROADMAP.md says the port does not carry
    Exception_("retrieval/index.py:fetch_pair", NOT_CARRIED, _ROADMAP),
    Exception_("models/sentence_encoder.py:embed_many_fn", NOT_CARRIED, _ROADMAP),
    Exception_("models/__init__.py:__all__[embed_many_fn]", NOT_CARRIED, _ROADMAP),
    Exception_("models/sentence_encoder.py:SentenceEncoder.encode_ids_many", NOT_CARRIED,
               _ROADMAP),
    Exception_("core/meshes.py:enable_compilation_cache", NOT_CARRIED, _ROADMAP),
    Exception_("core/__init__.py:__all__[enable_compilation_cache]", NOT_CARRIED, _ROADMAP),
    Exception_("core/meshes.py:flat_shard_index", "core/meshes.py:Mesh.flat_shard_index",
               "a method of the port's Mesh, which knows its own axes"),
)


# --------------------------------------------------------------------------
# Reading a tree
# --------------------------------------------------------------------------
_TREES: Dict[str, ast.Module] = {}


def _tree(path: str) -> Optional[ast.Module]:
    if path not in _TREES:
        if not os.path.isfile(path):
            return None
        with open(path, encoding="utf-8") as f:
            _TREES[path] = ast.parse(f.read(), filename=path)
    return _TREES[path]


def _arg_names(fn: ast.AST) -> List[str]:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return [n for n in names if n not in ("self", "cls")]


def _fields(cls: ast.ClassDef) -> List[str]:
    """A dataclass's / Flax module's / NamedTuple's fields: its annotated
    class-level names."""
    return [s.target.id for s in cls.body
            if isinstance(s, ast.AnnAssign) and isinstance(s.target, ast.Name)]


def _target_names(t: ast.expr) -> List[str]:
    """The names an assignment target binds (``x``, ``x, y``; not ``x.a``
    or ``x[i]``)."""
    if isinstance(t, ast.Name):
        return [t.id]
    if isinstance(t, (ast.Tuple, ast.List)):
        return [n for e in t.elts for n in _target_names(e)]
    if isinstance(t, ast.Starred):
        return _target_names(t.value)
    return []


def _bound_names(tree: ast.Module) -> Dict[str, ast.stmt]:
    """Every name a module binds at top level → the statement that binds it."""
    out: Dict[str, ast.stmt] = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in (node.targets if isinstance(node, ast.Assign) else [node.target]):
                for n in _target_names(t):
                    out[n] = node
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                out[(a.asname or a.name).split(".")[0]] = node
    return out


def _resolve(root: str, rel: str, name: str, depth: int = 0):
    """(module, node): the def or class bound to ``name`` in the package
    module ``rel`` and the module that defines it, through ``from
    <package>.x import name`` chains; (rel, None) when it is bound
    otherwise (or not at all)."""
    tree = _tree(os.path.join(root, rel))
    node = _bound_names(tree).get(name) if tree is not None and depth <= 8 else None
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
        return rel, node
    pkg = os.path.basename(root)
    if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith(pkg + "."):
        target = node.module[len(pkg) + 1:].replace(".", "/")
        rel2 = target + ".py"
        if not os.path.isfile(os.path.join(root, rel2)):
            rel2 = target + "/__init__.py"
        for a in node.names:
            if (a.asname or a.name) == name:
                return _resolve(root, rel2, a.name, depth + 1)
    return rel, None


def _members(root: str, rel: str, cls: ast.ClassDef, depth: int = 0):
    """(methods {name: args or None for a non-function member}, fields) of a
    port class, its bases' in the port included."""
    methods: Dict[str, Optional[List[str]]] = {}
    fields: List[str] = []
    for base in cls.bases if depth < 8 else ():
        name = base.id if isinstance(base, ast.Name) else None
        if isinstance(base, ast.Attribute) and base.attr == "Module":
            methods.setdefault("__call__", None)         # nn.Module: __call__ runs forward
        where, node = _resolve(root, rel, name) if name else (rel, None)
        if isinstance(node, ast.ClassDef):
            m, f = _members(root, where, node, depth + 1)
            methods.update(m)
            fields += f
    for s in cls.body:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef)):
            methods[s.name] = _arg_names(s)
        elif isinstance(s, (ast.Assign, ast.AnnAssign)):
            for t in (s.targets if isinstance(s, ast.Assign) else [s.target]):
                for n in _target_names(t):
                    methods.setdefault(n, None)
    fields += _fields(cls)
    return methods, fields


def _all_names(tree: ast.Module) -> List[str]:
    out: List[str] = []
    for node in tree.body:
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            if any(isinstance(t, ast.Name) and t.id == "__all__" for t in targets):
                out += [e.value for e in ast.walk(node.value)
                        if isinstance(e, ast.Constant) and isinstance(e.value, str)]
    return out


def _flags(root: str, rel: str) -> Set[str]:
    """The ``--flags`` a CLI module registers: ``add_argument`` literals,
    ``add_bool_flag(p, "name", ...)`` and the flags of the ``cli/common.py``
    helpers it calls."""
    common = _tree(os.path.join(root, "cli/common.py"))
    helpers = {n.name: n for n in (common.body if common else ())
               if isinstance(n, ast.FunctionDef) and n.name.startswith("add_")}

    def walk(node, seen) -> Set[str]:
        out: Set[str] = set()
        for call in ast.walk(node):
            if not isinstance(call, ast.Call):
                continue
            fname = (call.func.attr if isinstance(call.func, ast.Attribute)
                     else call.func.id if isinstance(call.func, ast.Name) else "")
            if fname == "add_argument":
                out |= {a.value for a in call.args
                        if isinstance(a, ast.Constant) and isinstance(a.value, str)
                        and a.value.startswith("--")}
            elif fname == "add_bool_flag" and len(call.args) > 1 and isinstance(
                    call.args[1], ast.Constant):
                out.add("--" + call.args[1].value)
            elif fname in helpers and fname not in seen:
                out |= walk(helpers[fname], seen | {fname})
        return out

    return walk(_tree(os.path.join(root, rel)), frozenset())


# --------------------------------------------------------------------------
# The check
# --------------------------------------------------------------------------
def _jax_modules() -> List[str]:
    out = []
    for dirpath, _, files in os.walk(JAX_ROOT):
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(dirpath, f), JAX_ROOT))
    return sorted(out)


def _check_args(out: List[str], symbol: str, want: List[str], have: Optional[List[str]]):
    if have is None:                 # bound some other way: no signature to hold it to
        return
    for a in want:
        if a not in have:
            out.append(f"{symbol}({a})")


def module_problems(jax_root: str, port_root: str, rel: str) -> List[str]:
    """What of ``jax_root/rel``'s public surface ``port_root`` lacks."""
    prel = FILE_MAP.get(rel, rel)
    jtree, ptree = _tree(os.path.join(jax_root, rel)), _tree(os.path.join(port_root, prel))
    if ptree is None:
        return [rel]
    out: List[str] = []
    bound = _bound_names(ptree)
    for node in jtree.body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            continue
        if node.name.startswith("_"):
            continue
        symbol = f"{rel}:{node.name}"
        if node.name not in bound:
            out.append(symbol)
            continue
        where, target = _resolve(port_root, prel, node.name)
        if isinstance(node, ast.ClassDef):
            if not isinstance(target, ast.ClassDef):
                continue
            methods, fields = _members(port_root, where, target)
            jmethods = {s.name: _arg_names(s) for s in node.body
                        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef))}
            if "__init__" not in jmethods and _fields(node):
                jmethods["__init__"] = _fields(node)
            for m, margs in jmethods.items():
                if m.startswith("_") and m not in ("__init__", "__call__"):
                    continue
                msym = f"{symbol}.{m}"
                if m == "__init__":
                    have = methods.get("__init__") if methods.get("__init__") else fields
                    _check_args(out, msym, margs, have)
                elif m == "__call__":
                    have = methods["forward"] if methods.get("forward") else methods.get(
                        "__call__")
                    if "forward" not in methods and "__call__" not in methods:
                        out.append(msym)
                    else:
                        _check_args(out, msym, margs, have)
                elif m not in methods:
                    out.append(msym)
                else:
                    _check_args(out, msym, margs, methods[m])
        elif isinstance(target, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _check_args(out, symbol, _arg_names(node), _arg_names(target))
    if os.path.basename(rel) == "__init__.py":
        have = set(_all_names(ptree))
        out += [f"{rel}:__all__[{n}]" for n in _all_names(jtree) if n not in have]
    if rel.startswith("cli/") and os.path.basename(rel) not in ("__init__.py", "common.py"):
        have = _flags(port_root, prel)
        out += [f"{rel}:{f}" for f in sorted(_flags(jax_root, rel)) if f not in have]
    return out


_EXCEPTED = {e.symbol for e in EXCEPTIONS}


@pytest.mark.parametrize("rel", _jax_modules())
def test_module_has_its_counterpart(rel):
    """Each JAX module's public names, arguments, exports and flags are in
    its port counterpart, but for the rows of EXCEPTIONS."""
    missing = [p for p in module_problems(JAX_ROOT, PORT_ROOT, rel) if p not in _EXCEPTED]
    assert not missing, f"qst_tpu_torch lacks: {missing}"


def test_every_exception_row_has_a_reason():
    for e in EXCEPTIONS:
        assert e.symbol and e.port.strip() and len(e.reason.split()) >= 3, e
    assert len(_EXCEPTED) == len(EXCEPTIONS), "a symbol has two rows"


def test_every_exception_row_is_still_needed():
    """A row whose symbol the checker no longer reports has gone stale."""
    seen = {p for rel in _jax_modules() for p in module_problems(JAX_ROOT, PORT_ROOT, rel)}
    assert not sorted(_EXCEPTED - seen)


# --------------------------------------------------------------------------
# The checker sees a deletion: doctored copies of the port
# --------------------------------------------------------------------------
def _drop_function(tree, name):
    tree.body = [n for n in tree.body if getattr(n, "name", None) != name]


def _drop_method(tree, cls_name, name):
    [cls] = [n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == cls_name]
    cls.body = [n for n in cls.body if getattr(n, "name", None) != name]


def _rename_arg(tree, qual, old):
    cls_name, _, fn_name = qual.rpartition(".")
    scope = tree.body
    if cls_name:
        [cls] = [n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == cls_name]
        scope = cls.body
    [fn] = [n for n in scope if isinstance(n, ast.FunctionDef) and n.name == fn_name]
    for a in fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs:
        if a.arg == old:
            a.arg = old + "_renamed"
            return
    raise AssertionError(f"{qual} has no argument {old}")


def _drop_export(tree, name):
    for node in ast.walk(tree):
        if isinstance(node, ast.List):
            node.elts = [e for e in node.elts
                         if not (isinstance(e, ast.Constant) and e.value == name)]


def _drop_flag(tree, flag):
    for node in ast.walk(tree):
        if hasattr(node, "body") and isinstance(node.body, list):
            node.body = [s for s in node.body if not (
                isinstance(s, ast.Expr) and isinstance(s.value, ast.Call)
                and any(isinstance(a, ast.Constant) and a.value == flag for a in s.value.args))]


DOCTORED = [
    ("ops/distances.py", lambda t: _drop_function(t, "cdist2"), "ops/distances.py:cdist2"),
    ("core/config.py", lambda t: _drop_function(t, "load_config"), "core/config.py:load_config"),
    ("retrieval/index.py", lambda t: _drop_method(t, "ExactIndex", "search"),
     "retrieval/index.py:ExactIndex.search"),
    ("core/config.py", lambda t: _rename_arg(t, "MeshConfig.shape", "n_devices"),
     "core/config.py:MeshConfig.shape(n_devices)"),
    ("models/__init__.py", lambda t: _drop_export(t, "import_bert_params"),
     "models/__init__.py:__all__[import_bert_params]"),
    ("cli/train_main.py", lambda t: _drop_flag(t, "--warmup_steps"),
     "cli/train_main.py:--warmup_steps"),
]


@pytest.mark.parametrize("rel,doctor,symbol", DOCTORED, ids=[d[2] for d in DOCTORED])
def test_checker_reports_a_name_deleted_from_a_copy(tmp_path, rel, doctor, symbol):
    """A copy of the port's sources with one name taken out of one module:
    the checker reports exactly that name, which it did not before."""
    root = tmp_path / "qst_tpu_torch"
    shutil.copytree(PORT_ROOT, root, ignore=shutil.ignore_patterns("_build", "__pycache__",
                                                                     "csrc"))
    jrel = {v: k for k, v in FILE_MAP.items()}.get(rel, rel)
    before = set(module_problems(JAX_ROOT, str(root), jrel))
    path = root / rel
    tree = ast.parse(path.read_text())
    doctor(tree)
    path.write_text(ast.unparse(tree))
    _TREES.pop(str(path), None)
    after = set(module_problems(JAX_ROOT, str(root), jrel))
    assert symbol not in before
    assert after - before == {symbol} and not before - after


def test_every_exported_name_resolves_without_jax():
    """In a fresh interpreter every name of every port package's
    ``__all__`` is got, and no jax, jaxlib, flax or qst_tpu module is
    loaded."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import qst_tpu_torch
        n = 0
        for m in pkgutil.iter_modules(qst_tpu_torch.__path__):
            if m.ispkg:
                pkg = importlib.import_module("qst_tpu_torch." + m.name)
                for name in getattr(pkg, "__all__", ()):
                    getattr(pkg, name)
                    n += 1
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "qst_tpu"))
        print(n, bad)
        sys.exit(1 if bad or n < 150 else 0)
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
