/* Native dataset-ingest runtime for sdslam_tpu.
 *
 * The reference's front-ends are native C++ (Examples/.../monocular.cc,
 * rgbd.cc: OpenCV imread on the camera thread). This translation unit is
 * this build's equivalent ingest runtime:
 *
 *   load_png_gray(path)        libpng decode to 8-bit grayscale (RGB(A)
 *                              converted) or raw 16-bit (TUM depth PNGs)
 *   pack_frame(...)            single-pass fill of the tracker's packed
 *                              upload buffer (u8 image | u16 depth lo/hi
 *                              planes | f32 timestamp trailer row)
 *   prefetcher_*               pthread worker pool decoding frames ahead
 *                              of the tracker into a bounded ring (the
 *                              host never stalls on PNG decode)
 *
 * Exposed through the same _native extension module (see native.c).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <png.h>
#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ---- PNG decode -------------------------------------------------------- */

typedef struct {
    uint8_t *data;      /* u8 gray, or u16 little-endian when bitdepth==16 */
    uint32_t w, h;
    int bitdepth;       /* 8 or 16 */
} gray_image_t;

/* returns 0 on success; caller frees img->data */
static int decode_png_gray(const char *path, gray_image_t *img) {
    FILE *fp = fopen(path, "rb");
    if (!fp) return -1;
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, NULL, NULL, NULL);
    png_infop info = png ? png_create_info_struct(png) : NULL;
    if (!png || !info) {
        if (png) png_destroy_read_struct(&png, info ? &info : NULL, NULL);
        fclose(fp);
        return -2;
    }
    if (setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, NULL);
        fclose(fp);
        return -3;
    }
    png_init_io(png, fp);
    png_read_info(png, info);
    png_uint_32 w = png_get_image_width(png, info);
    png_uint_32 h = png_get_image_height(png, info);
    int depth = png_get_bit_depth(png, info);
    int color = png_get_color_type(png, info);

    if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
    if (depth < 8) png_set_expand_gray_1_2_4_to_8(png);
    if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
    if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
        color == PNG_COLOR_TYPE_PALETTE)
        /* ITU-R BT.709 luma approximation, matches cv::cvtColor closely */
        png_set_rgb_to_gray_fixed(png, 1, 21260, 71520);
    if (depth == 16)
        png_set_swap(png); /* PNG is big-endian; we want LE u16 */
    png_read_update_info(png, info);

    size_t rowbytes = png_get_rowbytes(png, info);
    uint8_t *buf = malloc(rowbytes * h);
    png_bytep *rows = malloc(sizeof(png_bytep) * h);
    if (!buf || !rows) {
        free(buf); free(rows);
        png_destroy_read_struct(&png, &info, NULL);
        fclose(fp);
        return -4;
    }
    for (png_uint_32 y = 0; y < h; y++) rows[y] = buf + y * rowbytes;
    png_read_image(png, rows);
    png_destroy_read_struct(&png, &info, NULL);
    free(rows);
    fclose(fp);

    img->data = buf;
    img->w = w;
    img->h = h;
    img->bitdepth = (depth == 16) ? 16 : 8;
    return 0;
}

/* load_png_gray(path) -> (bytes, width, height, bitdepth) */
static PyObject *native_load_png_gray(PyObject *self, PyObject *args) {
    const char *path;
    if (!PyArg_ParseTuple(args, "s", &path)) return NULL;
    gray_image_t img;
    int rc;
    Py_BEGIN_ALLOW_THREADS
    rc = decode_png_gray(path, &img);
    Py_END_ALLOW_THREADS
    if (rc != 0) {
        PyErr_Format(PyExc_IOError, "PNG decode failed (%d): %s", rc, path);
        return NULL;
    }
    size_t nbytes = (size_t)img.w * img.h * (img.bitdepth / 8);
    PyObject *b = PyBytes_FromStringAndSize((const char *)img.data, (Py_ssize_t)nbytes);
    free(img.data);
    if (!b) return NULL;
    PyObject *out = Py_BuildValue("(NIIi)", b, img.w, img.h, img.bitdepth);
    return out;
}

/* ---- packed frame assembly --------------------------------------------- */

/* pack_frame(img: u8 buffer [H*W], depth: u16 buffer [H*W] or None,
 *            ts: float, out: writable u8 buffer [(H+1)*3W], H, W)
 * Fills: out[:H,:W]=img, out[:H,W:2W]=depth&0xFF, out[:H,2W:]=depth>>8,
 *        out[H,:4]=f32(ts) bytes. Single pass over the inputs. */
static PyObject *native_pack_frame(PyObject *self, PyObject *args) {
    Py_buffer img, depth, out;
    PyObject *depth_obj;
    double ts;
    int H, W;
    if (!PyArg_ParseTuple(args, "y*Odw*ii", &img, &depth_obj, &ts, &out, &H, &W))
        return NULL;
    int has_depth = depth_obj != Py_None;
    if (has_depth) {
        if (PyObject_GetBuffer(depth_obj, &depth, PyBUF_SIMPLE) < 0) {
            PyBuffer_Release(&img); PyBuffer_Release(&out);
            return NULL;
        }
    }
    size_t HW = (size_t)H * W;
    if (img.len < (Py_ssize_t)HW ||
        (has_depth && depth.len < (Py_ssize_t)(HW * 2)) ||
        out.len < (Py_ssize_t)((H + 1) * (size_t)(3 * W))) {
        PyBuffer_Release(&img); PyBuffer_Release(&out);
        if (has_depth) PyBuffer_Release(&depth);
        PyErr_SetString(PyExc_ValueError, "buffer sizes do not match H/W");
        return NULL;
    }
    const uint8_t *src = (const uint8_t *)img.buf;
    const uint16_t *dep = has_depth ? (const uint16_t *)depth.buf : NULL;
    uint8_t *dst = (uint8_t *)out.buf;
    Py_BEGIN_ALLOW_THREADS
    for (int y = 0; y < H; y++) {
        uint8_t *row = dst + (size_t)y * 3 * W;
        memcpy(row, src + (size_t)y * W, (size_t)W);
        if (dep) {
            const uint16_t *dr = dep + (size_t)y * W;
            uint8_t *lo = row + W, *hi = row + 2 * W;
            for (int x = 0; x < W; x++) {
                lo[x] = (uint8_t)(dr[x] & 0xFF);
                hi[x] = (uint8_t)(dr[x] >> 8);
            }
        } else {
            memset(row + W, 0, (size_t)(2 * W));
        }
    }
    float tsf = (float)ts;
    memcpy(dst + (size_t)H * 3 * W, &tsf, 4);
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&img); PyBuffer_Release(&out);
    if (has_depth) PyBuffer_Release(&depth);
    Py_RETURN_NONE;
}

/* pack_frame2(img: u8 buffer [H*W], depth: u16 buffer [H*W] or None,
 *             ts: float, out: writable u8 buffer [(H+H/2+1)*W], H, W)
 * v2 transport layout (half the v1 payload): out[:H,:W]=img; the depth plane DECIMATED 2x2
 * into rows H..H+H/2-1 as W/2 low bytes then W/2 high bytes per row;
 * f32(ts) in the first 4 bytes of the last row. H and W must be even. */
static PyObject *native_pack_frame2(PyObject *self, PyObject *args) {
    Py_buffer img, depth, out;
    PyObject *depth_obj;
    double ts;
    int H, W;
    if (!PyArg_ParseTuple(args, "y*Odw*ii", &img, &depth_obj, &ts, &out, &H, &W))
        return NULL;
    int has_depth = depth_obj != Py_None;
    if (has_depth) {
        if (PyObject_GetBuffer(depth_obj, &depth, PyBUF_SIMPLE) < 0) {
            PyBuffer_Release(&img); PyBuffer_Release(&out);
            return NULL;
        }
    }
    size_t HW = (size_t)H * W;
    int Hh = H / 2, Wh = W / 2;
    if ((H % 2) || (W % 2) || img.len < (Py_ssize_t)HW ||
        (has_depth && depth.len < (Py_ssize_t)(HW * 2)) ||
        out.len < (Py_ssize_t)((size_t)(H + Hh + 1) * W)) {
        PyBuffer_Release(&img); PyBuffer_Release(&out);
        if (has_depth) PyBuffer_Release(&depth);
        PyErr_SetString(PyExc_ValueError, "buffer sizes do not match H/W");
        return NULL;
    }
    const uint8_t *src = (const uint8_t *)img.buf;
    const uint16_t *dep = has_depth ? (const uint16_t *)depth.buf : NULL;
    uint8_t *dst = (uint8_t *)out.buf;
    Py_BEGIN_ALLOW_THREADS
    memcpy(dst, src, HW);
    for (int y = 0; y < Hh; y++) {
        uint8_t *row = dst + ((size_t)H + y) * W;
        if (dep) {
            const uint16_t *dr = dep + (size_t)(2 * y) * W;
            uint8_t *lo = row, *hi = row + Wh;
            for (int x = 0; x < Wh; x++) {
                uint16_t v = dr[2 * x];
                lo[x] = (uint8_t)(v & 0xFF);
                hi[x] = (uint8_t)(v >> 8);
            }
        } else {
            memset(row, 0, (size_t)W);
        }
    }
    /* deterministic payload: zero the trailer row past the timestamp so
     * uploads are byte-reproducible (the buffer may be uninitialized) */
    float tsf = (float)ts;
    uint8_t *trailer = dst + (size_t)(H + Hh) * W;
    memcpy(trailer, &tsf, 4);
    memset(trailer + 4, 0, (size_t)W - 4);
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&img); PyBuffer_Release(&out);
    if (has_depth) PyBuffer_Release(&depth);
    Py_RETURN_NONE;
}

/* ---- threaded prefetcher ------------------------------------------------ */

typedef struct {
    char *img_path;
    char *depth_path; /* NULL for mono */
    double ts;
} pf_job_t;

typedef struct {
    double ts;
    gray_image_t img;
    gray_image_t depth; /* data==NULL when absent */
    int rc;
} pf_result_t;

typedef struct {
    pf_job_t *jobs;
    int n_jobs;
    int next_job;         /* guarded by mu */
    pf_result_t *results; /* ring of capacity cap */
    int cap;
    int next_emit;        /* next job index to hand to Python */
    char *ready;          /* per-job done flags for the window */
    pthread_mutex_t mu;
    pthread_cond_t cv_done, cv_space;
    pthread_t *threads;
    int n_threads;
    int shutdown;
} prefetcher_t;

static void *pf_worker(void *arg) {
    prefetcher_t *p = (prefetcher_t *)arg;
    for (;;) {
        pthread_mutex_lock(&p->mu);
        while (!p->shutdown && p->next_job < p->n_jobs &&
               p->next_job - p->next_emit >= p->cap)
            pthread_cond_wait(&p->cv_space, &p->mu);
        if (p->shutdown || p->next_job >= p->n_jobs) {
            pthread_mutex_unlock(&p->mu);
            return NULL;
        }
        int j = p->next_job++;
        pthread_mutex_unlock(&p->mu);

        pf_result_t r;
        memset(&r, 0, sizeof(r));
        r.ts = p->jobs[j].ts;
        r.rc = decode_png_gray(p->jobs[j].img_path, &r.img);
        if (r.rc == 0 && p->jobs[j].depth_path)
            r.rc = decode_png_gray(p->jobs[j].depth_path, &r.depth);

        pthread_mutex_lock(&p->mu);
        p->results[j % p->cap] = r;
        p->ready[j % p->cap] = 1;
        pthread_cond_broadcast(&p->cv_done);
        pthread_mutex_unlock(&p->mu);
    }
}

static void pf_free(prefetcher_t *p) {
    pthread_mutex_lock(&p->mu);
    p->shutdown = 1;
    pthread_cond_broadcast(&p->cv_space);
    pthread_cond_broadcast(&p->cv_done);
    pthread_mutex_unlock(&p->mu);
    for (int i = 0; i < p->n_threads; i++) pthread_join(p->threads[i], NULL);
    for (int j = 0; j < p->n_jobs; j++) {
        free(p->jobs[j].img_path);
        free(p->jobs[j].depth_path);
    }
    /* free any undelivered decoded buffers */
    for (int j = p->next_emit; j < p->n_jobs && j < p->next_emit + p->cap; j++) {
        if (p->ready[j % p->cap]) {
            free(p->results[j % p->cap].img.data);
            free(p->results[j % p->cap].depth.data);
        }
    }
    free(p->jobs); free(p->results); free(p->ready); free(p->threads);
    pthread_mutex_destroy(&p->mu);
    pthread_cond_destroy(&p->cv_done);
    pthread_cond_destroy(&p->cv_space);
    free(p);
}

static void pf_capsule_destructor(PyObject *cap) {
    prefetcher_t *p = PyCapsule_GetPointer(cap, "sdslam_prefetcher");
    if (p) pf_free(p);
}

/* prefetcher_new(jobs: list[(img_path, depth_path|None, ts)],
 *                n_threads=2, depth=8) -> capsule */
static PyObject *native_prefetcher_new(PyObject *self, PyObject *args) {
    PyObject *jobs_list;
    int n_threads = 2, cap = 8;
    if (!PyArg_ParseTuple(args, "O|ii", &jobs_list, &n_threads, &cap))
        return NULL;
    PyObject *fast = PySequence_Fast(jobs_list, "expected a sequence");
    if (!fast) return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
    prefetcher_t *p = calloc(1, sizeof(prefetcher_t));
    p->jobs = calloc((size_t)(n > 0 ? n : 1), sizeof(pf_job_t));
    p->n_jobs = (int)n;
    p->cap = cap > 0 ? cap : 8;
    p->results = calloc((size_t)p->cap, sizeof(pf_result_t));
    p->ready = calloc((size_t)p->cap, 1);
    p->n_threads = n_threads > 0 ? n_threads : 2;
    p->threads = calloc((size_t)p->n_threads, sizeof(pthread_t));
    pthread_mutex_init(&p->mu, NULL);
    pthread_cond_init(&p->cv_done, NULL);
    pthread_cond_init(&p->cv_space, NULL);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *it = PySequence_Fast_GET_ITEM(fast, i);
        const char *ip = NULL, *dp = NULL;
        double ts = 0.0;
        PyObject *dobj;
        if (!PyArg_ParseTuple(it, "sOd", &ip, &dobj, &ts)) {
            Py_DECREF(fast);
            pf_free(p);
            return NULL;
        }
        if (dobj != Py_None) {
            dp = PyUnicode_AsUTF8(dobj);
            if (!dp) { Py_DECREF(fast); pf_free(p); return NULL; }
        }
        p->jobs[i].img_path = strdup(ip);
        p->jobs[i].depth_path = dp ? strdup(dp) : NULL;
        p->jobs[i].ts = ts;
    }
    Py_DECREF(fast);
    for (int i = 0; i < p->n_threads; i++)
        pthread_create(&p->threads[i], NULL, pf_worker, p);
    return PyCapsule_New(p, "sdslam_prefetcher", pf_capsule_destructor);
}

static PyObject *gray_to_pyobj(gray_image_t *g) {
    if (!g->data) Py_RETURN_NONE;
    size_t nbytes = (size_t)g->w * g->h * (g->bitdepth / 8);
    PyObject *b = PyBytes_FromStringAndSize((const char *)g->data, (Py_ssize_t)nbytes);
    free(g->data);
    g->data = NULL;
    if (!b) return NULL;
    return Py_BuildValue("(NIIi)", b, g->w, g->h, g->bitdepth);
}

/* prefetcher_next(capsule) -> (ts, img_tuple, depth_tuple|None) or None */
static PyObject *native_prefetcher_next(PyObject *self, PyObject *args) {
    PyObject *cap;
    if (!PyArg_ParseTuple(args, "O", &cap)) return NULL;
    prefetcher_t *p = PyCapsule_GetPointer(cap, "sdslam_prefetcher");
    if (!p) return NULL;
    pf_result_t r;
    int done = 0;
    Py_BEGIN_ALLOW_THREADS
    pthread_mutex_lock(&p->mu);
    if (p->next_emit >= p->n_jobs) {
        done = 1;
    } else {
        int j = p->next_emit;
        while (!p->ready[j % p->cap] && !p->shutdown)
            pthread_cond_wait(&p->cv_done, &p->mu);
        r = p->results[j % p->cap];
        p->ready[j % p->cap] = 0;
        p->next_emit++;
        pthread_cond_broadcast(&p->cv_space);
    }
    pthread_mutex_unlock(&p->mu);
    Py_END_ALLOW_THREADS
    if (done) Py_RETURN_NONE;
    if (r.rc != 0) {
        free(r.img.data); free(r.depth.data);
        PyErr_Format(PyExc_IOError, "prefetch decode failed (%d)", r.rc);
        return NULL;
    }
    PyObject *im = gray_to_pyobj(&r.img);
    if (!im) { free(r.depth.data); return NULL; }
    PyObject *de = gray_to_pyobj(&r.depth);
    if (!de) { Py_DECREF(im); return NULL; }
    return Py_BuildValue("(dNN)", r.ts, im, de);
}

/* exported for registration from native.c */
PyMethodDef sdslam_loader_methods[] = {
    {"load_png_gray", native_load_png_gray, METH_VARARGS,
     "load_png_gray(path) -> (bytes, w, h, bitdepth); RGB converted to gray"},
    {"pack_frame", native_pack_frame, METH_VARARGS,
     "pack_frame(img_u8, depth_u16|None, ts, out_u8, H, W): fill the packed "
     "tracker upload buffer in one pass"},
    {"pack_frame2", native_pack_frame2, METH_VARARGS,
     "pack_frame2(img_u8, depth_u16|None, ts, out_u8, H, W): v2 layout "
     "(2x2-decimated depth plane; half the payload)"},
    {"prefetcher_new", native_prefetcher_new, METH_VARARGS,
     "prefetcher_new(jobs, n_threads=2, depth=8) -> capsule"},
    {"prefetcher_next", native_prefetcher_next, METH_VARARGS,
     "prefetcher_next(capsule) -> (ts, (img,w,h,bd), (dep,w,h,bd)|None) | None"},
    {NULL, NULL, 0, NULL},
};
