/* Fast numeric-table parser for lightcurve files (QDP / CSV / dat).
 *
 * The port's own copy of mind_the_gaps_tpu/io/_fastio.c (the port imports
 * nothing of the JAX package); built by mind_the_gaps_tpu_torch/io/fastio.py
 * into mind_the_gaps_tpu_torch/_build/.
 *
 * Native tier of the data layer: the reference delegates all parsing to
 * np.genfromtxt (reference readingutils.py:104-227, loaders); genfromtxt
 * tokenizes in Python and is the bottleneck when loading directories of
 * thousands of bootstrap lightcurves (docs/workflow.md:43-92 persists
 * per-lightcurve .dat files between pipeline stages).  This extension
 * parses with strtod in C and RELEASES THE GIL, so bulk loads
 * parallelize across a thread pool (io/fastio.py:load_directory).
 *
 * No numpy C-API dependency: parse_table returns (bytes-of-f64, nrows,
 * ncols) and the Python wrapper reinterprets with np.frombuffer.
 *
 * Conventions (matching the formats the loaders read):
 * - lines whose first non-blank byte is '!', '#', ';' or '%' are comments;
 * - lines that contain no parseable number in their first token and are
 *   not data (e.g. "READ TERR 1 2", column-name headers) are skipped;
 * - the token "NO" (QDP's missing value) and "nan"/"NaN" parse as NaN;
 * - delimiters: any run of spaces, tabs or commas;
 * - the first data line fixes the column count; later lines with a
 *   different token count are skipped (counted in n_skipped).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <ctype.h>
#include <math.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
    double *buf;
    size_t len;
    size_t cap;
} dvec;

static int dvec_push(dvec *v, double x)
{
    if (v->len == v->cap) {
        size_t ncap = v->cap ? v->cap * 2 : 4096;
        double *nb = (double *)realloc(v->buf, ncap * sizeof(double));
        if (!nb) return -1;
        v->buf = nb;
        v->cap = ncap;
    }
    v->buf[v->len++] = x;
    return 0;
}

/* Parse one token starting at p (within [p, end)).  Returns the char
 * after the token; *ok = 1 and *out set when numeric (or NO/nan). */
static const char *parse_token(const char *p, const char *end, double *out, int *ok)
{
    const char *q = p;
    while (q < end && *q != ' ' && *q != '\t' && *q != ',' && *q != '\n' && *q != '\r')
        q++;
    size_t n = (size_t)(q - p);
    *ok = 0;
    if (n == 0) return q;
    if ((n == 2 && (p[0] == 'N' || p[0] == 'n') && (p[1] == 'O' || p[1] == 'o')) ||
        (n == 3 && (p[0] == 'n' || p[0] == 'N') && (p[1] == 'a' || p[1] == 'A') &&
         (p[2] == 'n' || p[2] == 'N'))) {
        *out = NAN;
        *ok = 1;
        return q;
    }
    char tmp[64];
    if (n >= sizeof(tmp)) return q;
    memcpy(tmp, p, n);
    tmp[n] = '\0';
    char *endptr = NULL;
    double val = strtod(tmp, &endptr);
    if (endptr && *endptr == '\0') {
        *out = val;
        *ok = 1;
    }
    return q;
}

/* Core parser: fills vals; returns rows via *nrows, cols via *ncols. */
static int parse_core(const char *data, Py_ssize_t size, dvec *vals,
                      Py_ssize_t *nrows, Py_ssize_t *ncols, Py_ssize_t *nskipped)
{
    const char *p = data;
    const char *end = data + size;
    Py_ssize_t cols = -1, rows = 0, skipped = 0;
    double rowbuf[512];

    while (p < end) {
        /* find line bounds */
        const char *line_end = memchr(p, '\n', (size_t)(end - p));
        if (!line_end) line_end = end;

        const char *q = p;
        while (q < line_end && (*q == ' ' || *q == '\t' || *q == ',' || *q == '\r'))
            q++;
        if (q >= line_end || *q == '!' || *q == '#' || *q == ';' || *q == '%') {
            p = line_end + 1;
            continue;
        }

        /* tokenize */
        Py_ssize_t ntok = 0;
        int all_ok = 1;
        const char *t = q;
        while (t < line_end) {
            while (t < line_end && (*t == ' ' || *t == '\t' || *t == ',' || *t == '\r'))
                t++;
            if (t >= line_end) break;
            double val;
            int ok;
            t = parse_token(t, line_end, &val, &ok);
            if (ntok < 512) {
                if (!ok) all_ok = 0;
                else rowbuf[ntok] = val;
            }
            ntok++;
        }
        if (ntok == 0 || !all_ok || ntok > 512) {
            /* header / non-numeric line */
            if (cols >= 0) skipped++;
            p = line_end + 1;
            continue;
        }
        if (cols < 0) cols = ntok;
        if (ntok != cols) {
            skipped++;
            p = line_end + 1;
            continue;
        }
        for (Py_ssize_t i = 0; i < cols; i++)
            if (dvec_push(vals, rowbuf[i]) < 0) return -1;
        rows++;
        p = line_end + 1;
    }
    *nrows = rows;
    *ncols = cols < 0 ? 0 : cols;
    *nskipped = skipped;
    return 0;
}

static PyObject *fastio_parse_table(PyObject *self, PyObject *args)
{
    Py_buffer view;
    if (!PyArg_ParseTuple(args, "y*", &view))
        return NULL;

    dvec vals = {NULL, 0, 0};
    Py_ssize_t nrows = 0, ncols = 0, nskipped = 0;
    int rc;

    Py_BEGIN_ALLOW_THREADS
    rc = parse_core((const char *)view.buf, view.len, &vals, &nrows, &ncols, &nskipped);
    Py_END_ALLOW_THREADS

    PyBuffer_Release(&view);
    if (rc < 0) {
        free(vals.buf);
        return PyErr_NoMemory();
    }
    PyObject *bytes = PyBytes_FromStringAndSize((const char *)vals.buf,
                                                (Py_ssize_t)(vals.len * sizeof(double)));
    free(vals.buf);
    if (!bytes) return NULL;
    PyObject *out = Py_BuildValue("Nnnn", bytes, nrows, ncols, nskipped);
    return out;
}

static PyMethodDef fastio_methods[] = {
    {"parse_table", fastio_parse_table, METH_VARARGS,
     "parse_table(data: bytes) -> (f64_bytes, nrows, ncols, nskipped)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef fastio_module = {
    PyModuleDef_HEAD_INIT, "_fastio",
    "Fast GIL-releasing numeric table parser", -1, fastio_methods,
};

PyMODINIT_FUNC PyInit__fastio(void)
{
    return PyModule_Create(&fastio_module);
}
