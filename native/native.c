/* sdslam_tpu._native: host-side runtime support in C.
 *
 * The reference implements its entire runtime natively (C++11); in this
 * re-architecture the compute path is JAX/XLA, and the native layer owns the
 * host-side hot paths around it:
 *   - associate():  O(n log n) two-pointer nearest-timestamp association of
 *                   sensor streams (the Python/reference associate.py tool
 *                   is O(n^2))
 *   - gray_to_f32() / depth_to_f32(): image buffer conversion/scaling
 *                   without intermediate Python objects
 *   - hamming_matrix_u8(): XOR+popcount descriptor distance matrix on the
 *                   host (CPU fallback / test oracle)
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ---- associate -------------------------------------------------------- */

typedef struct { double t; Py_ssize_t idx; } stamp_t;

static int cmp_stamp(const void *a, const void *b) {
    double d = ((const stamp_t *)a)->t - ((const stamp_t *)b)->t;
    return (d > 0) - (d < 0);
}

/* associate(ts_a: sequence[float], ts_b: sequence[float], max_diff: float)
 *   -> list[(ia, ib)]   greedy nearest-timestamp pairs, sorted by time   */
static PyObject *native_associate(PyObject *self, PyObject *args) {
    PyObject *seq_a, *seq_b;
    double max_diff, offset = 0.0;
    if (!PyArg_ParseTuple(args, "OOd|d", &seq_a, &seq_b, &max_diff, &offset))
        return NULL;
    PyObject *fa = PySequence_Fast(seq_a, "expected sequence");
    PyObject *fb = PySequence_Fast(seq_b, "expected sequence");
    if (!fa || !fb) { Py_XDECREF(fa); Py_XDECREF(fb); return NULL; }
    Py_ssize_t na = PySequence_Fast_GET_SIZE(fa);
    Py_ssize_t nb = PySequence_Fast_GET_SIZE(fb);
    stamp_t *A = malloc(sizeof(stamp_t) * (size_t)(na > 0 ? na : 1));
    stamp_t *B = malloc(sizeof(stamp_t) * (size_t)(nb > 0 ? nb : 1));
    char *used_b = calloc((size_t)(nb > 0 ? nb : 1), 1);
    if (!A || !B || !used_b) {
        free(A); free(B); free(used_b);
        Py_DECREF(fa); Py_DECREF(fb);
        return PyErr_NoMemory();
    }
    for (Py_ssize_t i = 0; i < na; i++) {
        A[i].t = PyFloat_AsDouble(PySequence_Fast_GET_ITEM(fa, i));
        A[i].idx = i;
    }
    for (Py_ssize_t i = 0; i < nb; i++) {
        B[i].t = PyFloat_AsDouble(PySequence_Fast_GET_ITEM(fb, i)) + offset;
        B[i].idx = i;
    }
    Py_DECREF(fa); Py_DECREF(fb);
    if (PyErr_Occurred()) { free(A); free(B); free(used_b); return NULL; }
    qsort(A, (size_t)na, sizeof(stamp_t), cmp_stamp);
    qsort(B, (size_t)nb, sizeof(stamp_t), cmp_stamp);

    PyObject *out = PyList_New(0);
    if (!out) { free(A); free(B); free(used_b); return NULL; }
    Py_ssize_t j0 = 0;
    for (Py_ssize_t i = 0; i < na; i++) {
        while (j0 < nb && B[j0].t < A[i].t - max_diff) j0++;
        double best_d = max_diff;
        Py_ssize_t best_j = -1;
        for (Py_ssize_t j = j0; j < nb && B[j].t <= A[i].t + max_diff; j++) {
            if (used_b[j]) continue;
            double d = B[j].t - A[i].t;
            if (d < 0) d = -d;
            if (d < best_d) { best_d = d; best_j = j; }
        }
        if (best_j >= 0) {
            used_b[best_j] = 1;
            PyObject *pair = Py_BuildValue("(nn)", A[i].idx, B[best_j].idx);
            if (!pair || PyList_Append(out, pair) < 0) {
                Py_XDECREF(pair); Py_DECREF(out);
                free(A); free(B); free(used_b);
                return NULL;
            }
            Py_DECREF(pair);
        }
    }
    free(A); free(B); free(used_b);
    return out;
}

/* ---- buffer conversions ---------------------------------------------- */

/* gray_to_f32(src: bytes (u8), out: writable buffer (f32), n) */
static PyObject *native_gray_to_f32(PyObject *self, PyObject *args) {
    Py_buffer src, dst;
    if (!PyArg_ParseTuple(args, "y*w*", &src, &dst)) return NULL;
    Py_ssize_t n = src.len;
    if (dst.len < n * (Py_ssize_t)sizeof(float)) {
        PyBuffer_Release(&src); PyBuffer_Release(&dst);
        PyErr_SetString(PyExc_ValueError, "output buffer too small");
        return NULL;
    }
    const uint8_t *s = (const uint8_t *)src.buf;
    float *d = (float *)dst.buf;
    for (Py_ssize_t i = 0; i < n; i++) d[i] = (float)s[i];
    PyBuffer_Release(&src); PyBuffer_Release(&dst);
    Py_RETURN_NONE;
}

/* depth_to_f32(src: bytes (u16 little-endian), out: f32 buffer, scale) */
static PyObject *native_depth_to_f32(PyObject *self, PyObject *args) {
    Py_buffer src, dst;
    double scale;
    if (!PyArg_ParseTuple(args, "y*w*d", &src, &dst, &scale)) return NULL;
    Py_ssize_t n = src.len / 2;
    if (dst.len < n * (Py_ssize_t)sizeof(float)) {
        PyBuffer_Release(&src); PyBuffer_Release(&dst);
        PyErr_SetString(PyExc_ValueError, "output buffer too small");
        return NULL;
    }
    const uint16_t *s = (const uint16_t *)src.buf;
    float *d = (float *)dst.buf;
    float inv = (float)(1.0 / scale);
    for (Py_ssize_t i = 0; i < n; i++) d[i] = (float)s[i] * inv;
    PyBuffer_Release(&src); PyBuffer_Release(&dst);
    Py_RETURN_NONE;
}

/* ---- Hamming ---------------------------------------------------------- */

/* hamming_matrix_u8(a: bytes [Na*32], b: bytes [Nb*32], out: i32 buffer) */
static PyObject *native_hamming(PyObject *self, PyObject *args) {
    Py_buffer a, b, dst;
    if (!PyArg_ParseTuple(args, "y*y*w*", &a, &b, &dst)) return NULL;
    Py_ssize_t na = a.len / 32, nb = b.len / 32;
    if (dst.len < na * nb * (Py_ssize_t)sizeof(int32_t)) {
        PyBuffer_Release(&a); PyBuffer_Release(&b); PyBuffer_Release(&dst);
        PyErr_SetString(PyExc_ValueError, "output buffer too small");
        return NULL;
    }
    const uint64_t *pa = (const uint64_t *)a.buf;
    const uint64_t *pb = (const uint64_t *)b.buf;
    int32_t *out = (int32_t *)dst.buf;
    for (Py_ssize_t i = 0; i < na; i++) {
        const uint64_t *ra = pa + i * 4;
        for (Py_ssize_t j = 0; j < nb; j++) {
            const uint64_t *rb = pb + j * 4;
            int32_t acc = 0;
            for (int k = 0; k < 4; k++)
                acc += (int32_t)__builtin_popcountll(ra[k] ^ rb[k]);
            out[i * nb + j] = acc;
        }
    }
    PyBuffer_Release(&a); PyBuffer_Release(&b); PyBuffer_Release(&dst);
    Py_RETURN_NONE;
}

static PyMethodDef methods[] = {
    {"associate", native_associate, METH_VARARGS,
     "associate(ts_a, ts_b, max_diff, offset=0) -> [(ia, ib), ...]"},
    {"gray_to_f32", native_gray_to_f32, METH_VARARGS,
     "convert u8 buffer to f32 buffer"},
    {"depth_to_f32", native_depth_to_f32, METH_VARARGS,
     "convert u16 depth buffer to f32 meters"},
    {"hamming_matrix_u8", native_hamming, METH_VARARGS,
     "256-bit descriptor Hamming distance matrix"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_native", "sdslam_tpu native runtime support",
    -1, methods,
};

/* dataset-ingest runtime (PNG decode, frame packing, threaded prefetcher) */
extern PyMethodDef sdslam_loader_methods[];

PyMODINIT_FUNC PyInit__native(void) {
    PyObject *m = PyModule_Create(&moduledef);
    if (!m) return NULL;
    if (PyModule_AddFunctions(m, sdslam_loader_methods) < 0) {
        Py_DECREF(m);
        return NULL;
    }
    return m;
}
