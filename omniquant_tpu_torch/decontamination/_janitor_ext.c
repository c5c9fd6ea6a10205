/* Fast 13-gram scanner for train/test decontamination.
 *
 * TPU-native framework's counterpart of the reference's optional
 * janitor_util.cpp (lm_eval/decontamination/janitor.py:8-15 expects a
 * pybind11 module; this one uses the plain CPython C API so no extra build
 * dependency is needed). Exposes:
 *
 *   clean_ngram(text, delete_chars, n) -> list[str]
 *   clean_ngram_with_indices(text, delete_chars, n) -> list[(str, start, end)]
 *
 * Normalization: ASCII-lowercase, characters in delete_chars removed,
 * whitespace tokenizes. Indices refer to the original string (start of the
 * n-gram's first word, end of its last word).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <ctype.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
    char *buf;        /* normalized word characters */
    Py_ssize_t len;
    Py_ssize_t start; /* position in original string */
    Py_ssize_t end;
} Word;

static PyObject *
clean_ngram_impl(PyObject *args, int with_indices)
{
    const char *s;
    Py_ssize_t slen;
    const char *del;
    Py_ssize_t dlen;
    int n;
    if (!PyArg_ParseTuple(args, "s#s#i", &s, &slen, &del, &dlen, &n))
        return NULL;
    if (n <= 0) {
        PyErr_SetString(PyExc_ValueError, "n must be positive");
        return NULL;
    }

    unsigned char delmap[256];
    memset(delmap, 0, sizeof delmap);
    for (Py_ssize_t i = 0; i < dlen; i++)
        delmap[(unsigned char)del[i]] = 1;

    /* tokenize */
    Py_ssize_t cap = 64, nwords = 0;
    Word *words = (Word *)malloc(cap * sizeof(Word));
    if (!words)
        return PyErr_NoMemory();
    char *cur = (char *)malloc(slen + 1);
    if (!cur) {
        free(words);
        return PyErr_NoMemory();
    }
    Py_ssize_t curlen = 0, curstart = -1, curend = -1;

    for (Py_ssize_t i = 0; i <= slen; i++) {
        unsigned char c = (i < slen) ? (unsigned char)s[i] : ' ';
        if (i < slen && delmap[c])
            continue; /* deleted char: skip, keep word open */
        if (i < slen && !isspace(c)) {
            cur[curlen++] = (char)tolower(c);
            if (curstart < 0)
                curstart = i;
            curend = i;
            continue;
        }
        if (curlen > 0) { /* close word */
            if (nwords == cap) {
                cap *= 2;
                Word *nw = (Word *)realloc(words, cap * sizeof(Word));
                if (!nw)
                    goto nomem;
                words = nw;
            }
            words[nwords].buf = (char *)malloc(curlen);
            if (!words[nwords].buf)
                goto nomem;
            memcpy(words[nwords].buf, cur, curlen);
            words[nwords].len = curlen;
            words[nwords].start = curstart;
            words[nwords].end = curend;
            nwords++;
            curlen = 0;
            curstart = curend = -1;
        }
    }
    free(cur);
    cur = NULL;

    PyObject *out = PyList_New(0);
    if (!out)
        goto nomem;

    if (nwords >= n) {
        /* reusable join buffer */
        Py_ssize_t maxjoin = 0;
        for (Py_ssize_t i = 0; i + n <= nwords; i++) {
            Py_ssize_t L = n; /* spaces */
            for (int j = 0; j < n; j++)
                L += words[i + j].len;
            if (L > maxjoin)
                maxjoin = L;
        }
        char *join = (char *)malloc(maxjoin + 1);
        if (!join) {
            Py_DECREF(out);
            goto nomem;
        }
        for (Py_ssize_t i = 0; i + n <= nwords; i++) {
            Py_ssize_t pos = 0;
            for (int j = 0; j < n; j++) {
                if (j) join[pos++] = ' ';
                memcpy(join + pos, words[i + j].buf, words[i + j].len);
                pos += words[i + j].len;
            }
            PyObject *item;
            if (with_indices) {
                item = Py_BuildValue(
                    "(s#nn)", join, pos, words[i].start,
                    words[i + n - 1].end + 1);
            } else {
                item = PyUnicode_FromStringAndSize(join, pos);
            }
            if (!item || PyList_Append(out, item) < 0) {
                Py_XDECREF(item);
                Py_DECREF(out);
                free(join);
                goto nomem;
            }
            Py_DECREF(item);
        }
        free(join);
    }

    for (Py_ssize_t i = 0; i < nwords; i++)
        free(words[i].buf);
    free(words);
    return out;

nomem:
    if (cur)
        free(cur);
    for (Py_ssize_t i = 0; i < nwords; i++)
        free(words[i].buf);
    free(words);
    if (!PyErr_Occurred())
        PyErr_NoMemory();
    return NULL;
}

static PyObject *
py_clean_ngram(PyObject *self, PyObject *args)
{
    (void)self;
    return clean_ngram_impl(args, 0);
}

static PyObject *
py_clean_ngram_with_indices(PyObject *self, PyObject *args)
{
    (void)self;
    return clean_ngram_impl(args, 1);
}

static PyMethodDef JanitorMethods[] = {
    {"clean_ngram", py_clean_ngram, METH_VARARGS,
     "clean_ngram(text, delete_chars, n) -> list of normalized n-grams"},
    {"clean_ngram_with_indices", py_clean_ngram_with_indices, METH_VARARGS,
     "clean_ngram_with_indices(text, delete_chars, n) -> list of "
     "(ngram, start, end)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef janitor_module = {
    PyModuleDef_HEAD_INIT, "_janitor_ext",
    "C 13-gram scanner for decontamination", -1, JanitorMethods,
    NULL, NULL, NULL, NULL,
};

PyMODINIT_FUNC
PyInit__janitor_ext(void)
{
    return PyModule_Create(&janitor_module);
}
