/* SearchResult: one search hit, (string id, distance), as a native type.
 *
 * A batched search hands back one object a hit: 6,400 a call at 64
 * queries and k = 100, each alive until the caller drops the answer. As
 * instances of a Python class they are tracked by the cyclic collector,
 * and each call's hits survive into the oldest generation, whose growth
 * sets off a full collection of the heap every few dozen calls. This type
 * has no Py_TPFLAGS_HAVE_GC, so the collector never sees its instances.
 * That is safe only because an instance can reach no container: ``id`` is
 * always an exact str (a str subclass is stored as the str of its
 * characters, anything else raises TypeError) and ``distance`` is a C
 * double.
 *
 * It behaves as the dataclass it replaces: positional or keyword
 * construction, settable fields, ``__match_args__``, equality on
 * (id, distance) with NotImplemented for other types, no hash, the
 * dataclass's repr, and copy and pickle through ``__reduce__``. Calls of
 * the type take the vectorcall path, so ``map(SearchResult, ids, dists)``
 * builds a hit without a Python-level ``__init__``.
 *
 * Built by ``vectordb_tpu_torch/utils/cext.py`` against the interpreter's
 * headers; no PyTorch headers.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

typedef struct {
    PyObject_HEAD
    PyObject *id;           /* an exact str */
    double distance;
} SearchResultObject;

static PyTypeObject SearchResultType;

/* A new reference to an exact str holding ``id``'s characters, or NULL
 * with TypeError where ``id`` is no str. */
static PyObject *
as_id(PyObject *id)
{
    if (PyUnicode_CheckExact(id)) {
        return Py_NewRef(id);
    }
    if (PyUnicode_Check(id)) {
        return PyUnicode_FromObject(id);
    }
    PyErr_Format(PyExc_TypeError, "SearchResult id must be str, not %.200s",
                 Py_TYPE(id)->tp_name);
    return NULL;
}

/* ``distance`` as a double; -1 with an exception set where it is no real
 * number. */
static int
as_distance(PyObject *distance, double *out)
{
    if (PyFloat_CheckExact(distance)) {
        *out = PyFloat_AS_DOUBLE(distance);
        return 0;
    }
    *out = PyFloat_AsDouble(distance);
    return (*out == -1.0 && PyErr_Occurred()) ? -1 : 0;
}

static PyObject *
make(PyObject *id, PyObject *distance)
{
    double d;
    if (as_distance(distance, &d) < 0) {
        return NULL;
    }
    PyObject *sid = as_id(id);
    if (sid == NULL) {
        return NULL;
    }
    SearchResultObject *self = PyObject_New(SearchResultObject,
                                            &SearchResultType);
    if (self == NULL) {
        Py_DECREF(sid);
        return NULL;
    }
    self->id = sid;
    self->distance = d;
    return (PyObject *)self;
}

static PyObject *
sr_vectorcall(PyObject *type, PyObject *const *args, size_t nargsf,
              PyObject *kwnames)
{
    Py_ssize_t nargs = PyVectorcall_NARGS(nargsf);
    PyObject *id = nargs > 0 ? args[0] : NULL;
    PyObject *distance = nargs > 1 ? args[1] : NULL;
    if (nargs > 2) {
        PyErr_Format(PyExc_TypeError, "SearchResult() takes 2 positional "
                     "arguments but %zd were given", nargs);
        return NULL;
    }
    Py_ssize_t nkw = kwnames == NULL ? 0 : PyTuple_GET_SIZE(kwnames);
    for (Py_ssize_t i = 0; i < nkw; i++) {
        PyObject *key = PyTuple_GET_ITEM(kwnames, i);
        PyObject **slot;
        if (PyUnicode_CompareWithASCIIString(key, "id") == 0) {
            slot = &id;
        }
        else if (PyUnicode_CompareWithASCIIString(key, "distance") == 0) {
            slot = &distance;
        }
        else {
            PyErr_Format(PyExc_TypeError, "SearchResult() got an "
                         "unexpected keyword argument '%U'", key);
            return NULL;
        }
        if (*slot != NULL) {
            PyErr_Format(PyExc_TypeError, "SearchResult() got multiple "
                         "values for argument '%U'", key);
            return NULL;
        }
        *slot = args[nargs + i];
    }
    if (id == NULL || distance == NULL) {
        PyErr_Format(PyExc_TypeError, "SearchResult() missing required "
                     "argument '%s'", id == NULL ? "id" : "distance");
        return NULL;
    }
    return make(id, distance);
}

static PyObject *
sr_new(PyTypeObject *type, PyObject *args, PyObject *kwds)
{
    static char *kwlist[] = {"id", "distance", NULL};
    PyObject *id, *distance;
    if (!PyArg_ParseTupleAndKeywords(args, kwds, "OO:SearchResult", kwlist,
                                     &id, &distance)) {
        return NULL;
    }
    return make(id, distance);
}

static void
sr_dealloc(SearchResultObject *self)
{
    Py_XDECREF(self->id);
    PyObject_Free(self);
}

static PyObject *
sr_repr(SearchResultObject *self)
{
    PyObject *d = PyFloat_FromDouble(self->distance);
    if (d == NULL) {
        return NULL;
    }
    PyObject *r = PyUnicode_FromFormat("SearchResult(id=%R, distance=%R)",
                                       self->id, d);
    Py_DECREF(d);
    return r;
}

/* The dataclass's ``__eq__``: (id, distance) against an instance of the
 * same type, NotImplemented otherwise; an instance equals itself, as a
 * tuple of its fields does, even with a NaN distance. */
static PyObject *
sr_richcompare(PyObject *a, PyObject *b, int op)
{
    if ((op != Py_EQ && op != Py_NE) || !Py_IS_TYPE(b, &SearchResultType)) {
        Py_RETURN_NOTIMPLEMENTED;
    }
    int eq = 1;
    if (a != b) {
        SearchResultObject *x = (SearchResultObject *)a;
        SearchResultObject *y = (SearchResultObject *)b;
        eq = PyObject_RichCompareBool(x->id, y->id, Py_EQ);
        if (eq < 0) {
            return NULL;
        }
        eq = eq && x->distance == y->distance;
    }
    return PyBool_FromLong(op == Py_EQ ? eq : !eq);
}

static PyObject *
sr_reduce(SearchResultObject *self, PyObject *Py_UNUSED(ignored))
{
    return Py_BuildValue("O(Od)", (PyObject *)Py_TYPE(self), self->id,
                         self->distance);
}

static PyObject *
sr_get_id(SearchResultObject *self, void *Py_UNUSED(closure))
{
    return Py_NewRef(self->id);
}

static int
sr_set_id(SearchResultObject *self, PyObject *value,
          void *Py_UNUSED(closure))
{
    if (value == NULL) {
        PyErr_SetString(PyExc_AttributeError, "cannot delete SearchResult.id");
        return -1;
    }
    PyObject *sid = as_id(value);
    if (sid == NULL) {
        return -1;
    }
    PyObject *old = self->id;
    self->id = sid;
    Py_XDECREF(old);
    return 0;
}

static PyObject *
sr_get_distance(SearchResultObject *self, void *Py_UNUSED(closure))
{
    return PyFloat_FromDouble(self->distance);
}

static int
sr_set_distance(SearchResultObject *self, PyObject *value,
                void *Py_UNUSED(closure))
{
    if (value == NULL) {
        PyErr_SetString(PyExc_AttributeError,
                        "cannot delete SearchResult.distance");
        return -1;
    }
    return as_distance(value, &self->distance);
}

static PyGetSetDef sr_getset[] = {
    {"id", (getter)sr_get_id, (setter)sr_set_id, "the hit's string id",
     NULL},
    {"distance", (getter)sr_get_distance, (setter)sr_set_distance,
     "the hit's distance (smaller is better)", NULL},
    {NULL},
};

static PyMethodDef sr_methods[] = {
    {"__reduce__", (PyCFunction)sr_reduce, METH_NOARGS, NULL},
    {NULL},
};

static PyTypeObject SearchResultType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "vectordb_tpu_torch.store.SearchResult",
    .tp_basicsize = sizeof(SearchResultObject),
    .tp_dealloc = (destructor)sr_dealloc,
    .tp_repr = (reprfunc)sr_repr,
    .tp_hash = PyObject_HashNotImplemented,
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_doc = "SearchResult(id, distance)\n--\n\n"
              "(string id, distance) search hit (reference: "
              "src/storage.rs:13-16).",
    .tp_richcompare = sr_richcompare,
    .tp_methods = sr_methods,
    .tp_getset = sr_getset,
    .tp_new = sr_new,
    .tp_vectorcall = sr_vectorcall,
};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT,
    .m_name = "_search_result",
    .m_doc = "The native SearchResult type.",
    .m_size = -1,
};

PyMODINIT_FUNC
PyInit__search_result(void)
{
    if (PyType_Ready(&SearchResultType) < 0) {
        return NULL;
    }
    PyObject *match_args = Py_BuildValue("(ss)", "id", "distance");
    if (match_args == NULL) {
        return NULL;
    }
    int rc = PyDict_SetItemString(SearchResultType.tp_dict,
                                  "__match_args__", match_args);
    Py_DECREF(match_args);
    if (rc < 0) {
        return NULL;
    }
    PyType_Modified(&SearchResultType);
    PyObject *m = PyModule_Create(&module);
    if (m == NULL) {
        return NULL;
    }
    if (PyModule_AddObjectRef(m, "SearchResult",
                              (PyObject *)&SearchResultType) < 0) {
        Py_DECREF(m);
        return NULL;
    }
    return m;
}
