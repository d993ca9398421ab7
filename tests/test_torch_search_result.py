"""The native ``SearchResult`` (``csrc/search_result.c``) against the
dataclass it replaced, rebuilt here as the oracle: construction, equality,
no hash, repr, copy and pickle, settable fields, the id's type check, and
that the collector does not track an instance; and its build
(``utils/cext.py``): a missing source or a failed build raises, builds at
once all load."""

import copy
import gc
import pickle
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path

import pytest

from vectordb_tpu_torch import SearchResult
from vectordb_tpu_torch import store as store_mod
from vectordb_tpu_torch.utils import cext

ROOT = Path(__file__).resolve().parent.parent


@dataclass
class Oracle:
    """The dataclass ``SearchResult`` this type replaced."""
    id: str
    distance: float


Oracle.__qualname__ = "SearchResult"        # its repr's name


def _fields(r):
    return (type(r.id), r.id, type(r.distance), r.distance)


def _same(native, oracle):
    assert _fields(native) == _fields(oracle)
    assert repr(native) == repr(oracle)


CONSTRUCTIONS = {
    "positional": (("7", 0.25), {}),
    "keyword": ((), {"id": "7", "distance": 0.25}),
    "keyword-reversed": ((), {"distance": 0.25, "id": "7"}),
    "mixed": (("7",), {"distance": 0.25}),
    "negative": (("a b", -1.5e-300), {}),
    "inf": (("x",), {"distance": float("inf")}),
    "empty-id": (("", 0.0), {}),
    "unicode-id": (("ré中\U0001f600", 3.0), {}),
}


@pytest.mark.parametrize("how", list(CONSTRUCTIONS))
def test_construction_matches_the_dataclass(how):
    args, kwargs = CONSTRUCTIONS[how]
    _same(SearchResult(*args, **kwargs), Oracle(*args, **kwargs))


@pytest.mark.parametrize("how", ["map", "new"])
def test_every_call_path_builds_the_same_hit(how):
    ids, dists = ["a", "b", "c"], [0.5, 1.0, 2.5]
    if how == "map":
        got = list(map(SearchResult, ids, dists))
    else:
        got = [SearchResult.__new__(SearchResult, i, distance=d)
               for i, d in zip(ids, dists)]
    for g, w in zip(got, map(Oracle, ids, dists)):
        _same(g, w)


BAD_CALLS = {
    "no-args": ((), {}),
    "no-distance": (("a",), {}),
    "no-id": ((), {"distance": 1.0}),
    "three-positional": (("a", 1.0, 2.0), {}),
    "duplicate-id": (("a",), {"id": "b", "distance": 1.0}),
    "unknown-keyword": (("a", 1.0), {"score": 1.0}),
}


@pytest.mark.parametrize("how", list(BAD_CALLS))
def test_bad_calls_raise_as_the_dataclass_does(how):
    args, kwargs = BAD_CALLS[how]
    with pytest.raises(TypeError):
        Oracle(*args, **kwargs)
    with pytest.raises(TypeError):
        SearchResult(*args, **kwargs)


PAIRS = {
    "equal": (("a", 1.0), ("a", 1.0)),
    "other-id": (("a", 1.0), ("b", 1.0)),
    "other-distance": (("a", 1.0), ("a", 1.5)),
    "int-distance": (("a", 2), ("a", 2.0)),
    "signed-zero": (("a", 0.0), ("a", -0.0)),
}


@pytest.mark.parametrize("pair", list(PAIRS))
def test_equality_matches_the_dataclass(pair):
    a, b = PAIRS[pair]
    na, nb = SearchResult(*a), SearchResult(*b)
    oa, ob = Oracle(*a), Oracle(*b)
    assert (na == nb) == (oa == ob)
    assert (na != nb) == (oa != ob)
    assert (nb == na) == (ob == oa)


OTHERS = {"tuple": ("a", 1.0), "str": "a", "none": None,
          "dataclass": Oracle("a", 1.0)}


@pytest.mark.parametrize("other", list(OTHERS))
def test_another_type_is_never_equal(other):
    r, o = SearchResult("a", 1.0), OTHERS[other]
    assert r.__eq__(o) is NotImplemented
    assert not r == o and r != o
    assert not o == r and o != r
    with pytest.raises(TypeError):
        r < SearchResult("b", 2.0)


def test_an_instance_equals_itself_even_with_a_nan_distance():
    r, o = SearchResult("a", float("nan")), Oracle("a", float("nan"))
    assert (r == r) == (o == o) is True
    assert (r != r) == (o != o) is False


def test_unhashable():
    assert SearchResult.__hash__ is None is Oracle.__hash__
    with pytest.raises(TypeError):
        hash(SearchResult("a", 1.0))
    with pytest.raises(TypeError):
        {SearchResult("a", 1.0)}


@pytest.mark.parametrize("id,distance", [("7", 0.25), ("it's", -3.0),
                                         ('q"1', 1e-30), ("n", 1e300)])
def test_repr_matches_the_dataclass(id, distance):
    assert repr(SearchResult(id, distance)) == repr(Oracle(id, distance))
    assert str(SearchResult(id, distance)) == str(Oracle(id, distance))


def test_repr_of_the_reference_hit():
    assert repr(SearchResult("7", 0.25)) == (
        "SearchResult(id='7', distance=0.25)")


ROUND_TRIPS = {"copy": copy.copy, "deepcopy": copy.deepcopy,
               **{f"pickle-{p}": (lambda r, p=p: pickle.loads(
                   pickle.dumps(r, protocol=p)))
                  for p in range(pickle.HIGHEST_PROTOCOL + 1)}}


@pytest.mark.parametrize("how", list(ROUND_TRIPS))
def test_copy_and_pickle_round_trip(how):
    r = SearchResult("r42", 0.1 + 0.2)
    got = ROUND_TRIPS[how](r)
    assert type(got) is SearchResult and got is not r
    assert got == r and _fields(got) == _fields(r)
    assert not gc.is_tracked(got)


def test_pickles_by_the_store_module_path():
    assert SearchResult.__module__ == "vectordb_tpu_torch.store"
    assert SearchResult.__qualname__ == "SearchResult"
    assert store_mod.SearchResult is SearchResult


@pytest.mark.parametrize("field,value", [("id", "b"), ("id", ""),
                                         ("distance", 2.5),
                                         ("distance", -0.0)])
def test_fields_are_settable(field, value):
    r, o = SearchResult("a", 1.0), Oracle("a", 1.0)
    setattr(r, field, value)
    setattr(o, field, value)
    _same(r, o)
    assert r == SearchResult(o.id, o.distance)


@pytest.mark.parametrize("field", ["id", "distance"])
def test_fields_cannot_be_deleted_or_added(field):
    r = SearchResult("a", 1.0)
    with pytest.raises(AttributeError):
        delattr(r, field)
    with pytest.raises(AttributeError):
        r.other = 1
    assert not hasattr(r, "__dict__")


@pytest.mark.parametrize("bad", [1, 1.5, None, b"a", ["a"]],
                         ids=["int", "float", "none", "bytes", "list"])
@pytest.mark.parametrize("where", ["call", "keyword", "setter"])
def test_an_id_that_is_no_str_raises(bad, where):
    with pytest.raises(TypeError):
        if where == "call":
            SearchResult(bad, 1.0)
        elif where == "keyword":
            SearchResult(id=bad, distance=1.0)
        else:
            SearchResult("a", 1.0).id = bad


class _Str(str):
    pass


@pytest.mark.parametrize("where", ["call", "setter"])
def test_a_str_subclass_id_is_stored_as_an_exact_str(where):
    sub = _Str("r7")
    if where == "call":
        r = SearchResult(sub, 1.0)
    else:
        r = SearchResult("a", 1.0)
        r.id = sub
    assert type(r.id) is str and r.id == "r7"
    assert r == SearchResult("r7", 1.0)


@pytest.mark.parametrize("value,want", [(2, 2.0), (True, 1.0),
                                        (0.1, 0.1)])
def test_a_real_distance_is_stored_as_a_float(value, want):
    r = SearchResult("a", value)
    assert type(r.distance) is float and r.distance == want


@pytest.mark.parametrize("bad", ["1.0", None, 1j])
def test_a_distance_that_is_no_real_number_raises(bad):
    with pytest.raises(TypeError):
        SearchResult("a", bad)
    with pytest.raises(TypeError):
        SearchResult("a", 1.0).distance = bad


def test_a_python_float_distance_is_kept_bit_for_bit():
    for x in (0.1, 1 / 3, 5e-324, -2.2250738585072014e-308,
              1.7976931348623157e308):
        assert SearchResult("a", x).distance.hex() == x.hex()


@pytest.mark.parametrize("how", ["positional", "keyword", "map", "copy",
                                 "pickle"])
def test_the_collector_does_not_track_a_hit(how):
    if how == "positional":
        r = SearchResult("a", 1.0)
    elif how == "keyword":
        r = SearchResult(id="a", distance=1.0)
    elif how == "map":
        r = next(map(SearchResult, ["a"], [1.0]))
    elif how == "copy":
        r = copy.copy(SearchResult("a", 1.0))
    else:
        r = pickle.loads(pickle.dumps(SearchResult("a", 1.0)))
    assert gc.is_tracked(r) is False
    assert gc.is_tracked(Oracle("a", 1.0)) is True


def test_match_args_and_pattern_matching():
    assert SearchResult.__match_args__ == Oracle.__match_args__ == (
        "id", "distance")
    match SearchResult("r1", 0.5):
        case SearchResult(sid, dist):
            assert (sid, dist) == ("r1", 0.5)
        case _:
            pytest.fail("no match")


def test_a_failed_build_raises_with_the_compilers_log(tmp_path,
                                                       monkeypatch):
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "broken.c").write_text("int f(void) { return }\n")
    monkeypatch.setattr(cext, "_PKG", tmp_path)
    monkeypatch.setattr(cext, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="broken.c build failed") as err:
        cext.load("broken")
    assert "error" in str(err.value)
    assert not list((tmp_path / "_build").iterdir())    # no partial file


def test_a_missing_source_raises_and_builds_nothing(tmp_path, monkeypatch):
    # an install that left csrc/ out says so, as the persistence core does
    monkeypatch.setattr(cext, "_PKG", tmp_path)
    monkeypatch.setattr(cext, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="missing.c sources not found"):
        cext.load("missing")
    assert not (tmp_path / "_build").exists()


def test_builds_at_once_leave_one_whole_module(tmp_path):
    # processes that find no build compile at once: each writes its own
    # temporary file and renames it into place, so every one loads
    code = ("import sys; from pathlib import Path; "
            "from vectordb_tpu_torch.utils import cext; "
            "cext.BUILD_DIR = Path(sys.argv[1]); "
            "r = cext.load('search_result').SearchResult('a', 1.0); "
            "print(repr(r))")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              stdout=subprocess.PIPE, text=True,
                              cwd=ROOT) for _ in range(4)]
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * 4
    assert outs == ["SearchResult(id='a', distance=1.0)\n"] * 4
    assert [p.name for p in tmp_path.iterdir()] == [
        cext._build("search_result").name]
