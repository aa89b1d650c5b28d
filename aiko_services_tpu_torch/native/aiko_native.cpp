// Native host-path kernels for the port's control plane — CPython
// extension.  The port's own copy of the JAX package's extension: the
// same C++, with its parity comments pointing at the port's modules.
//
// Every control-plane message crosses topic_matches() (wildcard routing,
// process.py) and the S-expression parser (utils/sexpr.py); at the
// reference's stated scale goal (1k-10k services/process, reference:
// aiko_services/process.py:45-48) these dominate host CPU.  A CPython
// extension (not ctypes: per-call marshalling erases the win) builds the
// parse tree directly as Python objects.  aiko_services_tpu_torch/
// transport/message.py and utils/sexpr.py keep identical pure-Python
// plain versions; tests/test_torch_native.py asserts parity.
//
// Built on demand by native/__init__.py into aiko_services_tpu_torch/
// _build/:
//   g++ -O2 -shared -fPIC -I<python-include> aiko_native.cpp

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstring>
#include <vector>

// ---------------------------------------------------------------------------
// topic matching (parity: aiko_services_tpu_torch/transport/message.py
// _py_topic_matches)
// ---------------------------------------------------------------------------

static bool topic_matches_impl(const char *pattern, const char *topic) {
    if (strcmp(pattern, topic) == 0) return true;
    const char *p = pattern, *t = topic;
    bool t_exhausted = false;
    for (;;) {
        const char *pe = p;
        while (*pe && *pe != '/') pe++;
        if (pe - p == 1 && *p == '#') return true;
        if (t_exhausted) return false;      // pattern longer than topic
        const char *te = t;
        while (*te && *te != '/') te++;
        if (!(pe - p == 1 && *p == '+')) {
            if ((pe - p) != (te - t) || strncmp(p, t, pe - p) != 0)
                return false;
        }
        bool p_end = (*pe == '\0');
        bool t_end = (*te == '\0');
        if (p_end) return t_end;
        p = pe + 1;
        if (t_end) { t_exhausted = true; } else { t = te + 1; }
    }
}

static PyObject *py_topic_matches(PyObject *, PyObject *args) {
    const char *pattern, *topic;
    if (!PyArg_ParseTuple(args, "ss", &pattern, &topic)) return nullptr;
    return PyBool_FromLong(topic_matches_impl(pattern, topic));
}

// ---------------------------------------------------------------------------
// S-expression parser (parity: aiko_services_tpu_torch/utils/sexpr.py
// _parse_sexpr_py)
// ---------------------------------------------------------------------------

static PyObject *parse_error;       // set from Python (sexpr.ParseError)

struct Token {
    char kind;          // '(', ')', 'A' atom, 'R' raw (length-prefixed)
    Py_ssize_t start;
    Py_ssize_t end;
};

static bool is_space(char c) {
    return c == ' ' || c == '\t' || c == '\r' || c == '\n';
}

// returns false + sets parse_error on overrun
static bool tokenize_impl(const char *text, Py_ssize_t n,
                          std::vector<Token> &tokens) {
    Py_ssize_t i = 0;
    while (i < n) {
        char ch = text[i];
        if (is_space(ch)) { i++; continue; }
        if (ch == '(' || ch == ')') {
            tokens.push_back({ch, i, i + 1});
            i++;
            continue;
        }
        Py_ssize_t j = i;
        bool emitted = false;
        while (j < n) {
            char cj = text[j];
            if (cj == '(' || cj == ')' || is_space(cj)) break;
            if (cj == ':' && j > i) {
                bool all_digits = true;
                for (Py_ssize_t k = i; k < j; k++)
                    if (text[k] < '0' || text[k] > '9') {
                        all_digits = false;
                        break;
                    }
                if (all_digits) {
                    long long length = 0;
                    for (Py_ssize_t k = i; k < j; k++)
                        length = length * 10 + (text[k] - '0');
                    Py_ssize_t start = j + 1;
                    if (start + (Py_ssize_t)length > n) {
                        PyErr_SetString(
                            parse_error ? parse_error : PyExc_ValueError,
                            "length-prefixed token overruns payload");
                        return false;
                    }
                    tokens.push_back({'R', start,
                                      start + (Py_ssize_t)length});
                    i = start + (Py_ssize_t)length;
                    emitted = true;
                    break;
                }
            }
            j++;
        }
        if (emitted) continue;
        tokens.push_back({'A', i, j});
        i = j;
    }
    return true;
}

// dict-key test: plain atom (not raw), ends with ':', length > 1
static bool is_dict_key(const char *text, const Token &token) {
    if (token.kind != 'A') return false;
    Py_ssize_t length = token.end - token.start;
    return length > 1 && text[token.end - 1] == ':';
}

// group close: convert items (+ their tokens) to dict when they form
// "key: value" pairs (parity: aiko_services_tpu_torch/utils/sexpr.py
// _maybe_dict)
static PyObject *maybe_dict(const char *text, PyObject *items,
                            const std::vector<char> &kinds,
                            const std::vector<Token> &key_tokens) {
    Py_ssize_t count = PyList_GET_SIZE(items);
    if (count == 0 || count % 2) {
        Py_INCREF(items);
        return items;
    }
    for (Py_ssize_t i = 0; i < count; i += 2) {
        // keys must be atom strings flagged as dict keys
        if (kinds[i] != 'K') {
            Py_INCREF(items);
            return items;
        }
    }
    (void)text; (void)key_tokens;
    PyObject *dict = PyDict_New();
    if (!dict) return nullptr;
    for (Py_ssize_t i = 0; i < count; i += 2) {
        PyObject *key_full = PyList_GET_ITEM(items, i);   // "name:"
        Py_ssize_t key_length;
        const char *key_text = PyUnicode_AsUTF8AndSize(key_full,
                                                       &key_length);
        if (!key_text) { Py_DECREF(dict); return nullptr; }
        PyObject *key = PyUnicode_FromStringAndSize(key_text,
                                                    key_length - 1);
        if (!key) { Py_DECREF(dict); return nullptr; }
        if (PyDict_SetItem(dict, key,
                           PyList_GET_ITEM(items, i + 1)) < 0) {
            Py_DECREF(key);
            Py_DECREF(dict);
            return nullptr;
        }
        Py_DECREF(key);
    }
    return dict;
}

// recursive reader over the token stream
static PyObject *read_expr(const char *text,
                           const std::vector<Token> &tokens,
                           size_t &pos, char *out_kind) {
    const Token &token = tokens[pos];
    if (token.kind == '(') {
        pos++;
        PyObject *items = PyList_New(0);
        if (!items) return nullptr;
        std::vector<char> kinds;
        std::vector<Token> item_tokens;
        while (pos < tokens.size() && tokens[pos].kind != ')') {
            char kind = 0;
            Token item_token = tokens[pos];
            PyObject *item = read_expr(text, tokens, pos, &kind);
            if (!item) { Py_DECREF(items); return nullptr; }
            if (PyList_Append(items, item) < 0) {
                Py_DECREF(item);
                Py_DECREF(items);
                return nullptr;
            }
            Py_DECREF(item);
            kinds.push_back(kind);
            item_tokens.push_back(item_token);
        }
        if (pos >= tokens.size()) {
            Py_DECREF(items);
            PyErr_SetString(parse_error ? parse_error : PyExc_ValueError,
                            "unbalanced '(' in payload");
            return nullptr;
        }
        pos++;      // consume ')'
        PyObject *result = maybe_dict(text, items, kinds, item_tokens);
        Py_DECREF(items);
        *out_kind = 'G';
        return result;
    }
    if (token.kind == ')') {
        PyErr_SetString(parse_error ? parse_error : PyExc_ValueError,
                        "unbalanced ')' in payload");
        return nullptr;
    }
    pos++;
    *out_kind = (token.kind == 'A' && is_dict_key(text, token)) ? 'K'
                : token.kind;        // 'A' plain, 'R' raw, 'K' dict key
    return PyUnicode_FromStringAndSize(text + token.start,
                                       token.end - token.start);
}

static PyObject *py_parse_sexpr(PyObject *, PyObject *args) {
    const char *text;
    Py_ssize_t n;
    if (!PyArg_ParseTuple(args, "s#", &text, &n)) return nullptr;

    std::vector<Token> tokens;
    if (!tokenize_impl(text, n, tokens)) return nullptr;
    if (tokens.empty()) return PyList_New(0);

    size_t pos = 0;
    char kind = 0;
    PyObject *expr = read_expr(text, tokens, pos, &kind);
    if (!expr) return nullptr;
    if (pos != tokens.size()) {
        Py_DECREF(expr);
        PyErr_SetString(parse_error ? parse_error : PyExc_ValueError,
                        "trailing tokens after expression");
        return nullptr;
    }
    return expr;
}

static PyObject *py_set_parse_error(PyObject *, PyObject *args) {
    PyObject *exc;
    if (!PyArg_ParseTuple(args, "O", &exc)) return nullptr;
    Py_XINCREF(exc);
    Py_XDECREF(parse_error);
    parse_error = exc;
    Py_RETURN_NONE;
}

static PyMethodDef methods[] = {
    {"topic_matches", py_topic_matches, METH_VARARGS,
     "MQTT-style wildcard topic match"},
    {"parse_sexpr", py_parse_sexpr, METH_VARARGS,
     "Parse an S-expression payload into nested lists/dicts"},
    {"set_parse_error", py_set_parse_error, METH_VARARGS,
     "Install the ParseError exception class"},
    {nullptr, nullptr, 0, nullptr},
};

static struct PyModuleDef module_def = {
    PyModuleDef_HEAD_INIT, "_aiko_native",
    "Native control-plane kernels", -1, methods,
    nullptr, nullptr, nullptr, nullptr,
};

PyMODINIT_FUNC PyInit__aiko_native(void) {
    return PyModule_Create(&module_def);
}
