/* RLP codec as a CPython extension — the hot host loop of trie commits.
 *
 * Semantics are bit-identical to khipu_tpu_torch/base/rlp.py (the
 * pure-Python reference implementation, kept as the differential oracle
 * in tests): Yellow Paper appendix B encoding, canonical-form
 * enforcement on decode, MAX_DEPTH nesting cap.
 * Role parity: khipu-base/src/main/scala/khipu/rlp/RLP.scala:35.
 *
 * Errors raise the exception class installed via _set_error (the
 * package passes base.rlp.RLPError so callers see one exception type
 * regardless of backend).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#define MAX_DEPTH 64

static PyObject *rlp_error = NULL; /* set via _set_error */
static PyObject *enc_hook = NULL;  /* test-only: runs between passes */

static void set_err(const char *msg) {
  PyErr_SetString(rlp_error ? rlp_error : PyExc_ValueError, msg);
}

/* ------------------------------------------------------------ encode */

static int enc_size(PyObject *o, Py_ssize_t *out, int depth) {
  const char *buf;
  Py_ssize_t n;
  if (PyBytes_CheckExact(o)) {
    buf = PyBytes_AS_STRING(o);
    n = PyBytes_GET_SIZE(o);
  } else if (PyByteArray_CheckExact(o)) {
    buf = PyByteArray_AS_STRING(o);
    n = PyByteArray_GET_SIZE(o);
  } else if (PyList_CheckExact(o) || PyTuple_CheckExact(o)) {
    if (depth >= MAX_DEPTH) {
      set_err("RLP nesting exceeds MAX_DEPTH");
      return -1;
    }
    int is_list = PyList_CheckExact(o);
    Py_ssize_t k = is_list ? PyList_GET_SIZE(o) : PyTuple_GET_SIZE(o);
    Py_ssize_t total = 0;
    for (Py_ssize_t i = 0; i < k; ++i) {
      PyObject *c = is_list ? PyList_GET_ITEM(o, i) : PyTuple_GET_ITEM(o, i);
      Py_ssize_t s;
      if (enc_size(c, &s, depth + 1) < 0) return -1;
      total += s;
    }
    if (total < 56) {
      *out = 1 + total;
    } else {
      Py_ssize_t l = total, lb = 0;
      while (l) { lb++; l >>= 8; }
      *out = 1 + lb + total;
    }
    return 0;
  } else {
    set_err("cannot RLP-encode object (want bytes or list)");
    return -1;
  }
  if (n == 1 && (unsigned char)buf[0] < 0x80) {
    *out = 1;
  } else if (n < 56) {
    *out = 1 + n;
  } else {
    Py_ssize_t l = n, lb = 0;
    while (l) { lb++; l >>= 8; }
    *out = 1 + lb + n;
  }
  return 0;
}

/* The write pass is CLAMPED to the buffer sized by enc_size: a
 * bytearray resized between the two passes (e.g. by a GC finalizer
 * running on an allocation inside py_encode) must never let memcpy
 * run past the output bytes object. Every write site bounds-checks
 * against `end`; py_encode additionally requires the exact sized
 * length to be produced, so a shrink is rejected too. */

static char *write_len(char *p, const char *end, Py_ssize_t n,
                       unsigned char offset) {
  if (n < 56) {
    if (end - p < 1) { set_err("RLP input resized during encode"); return NULL; }
    *p++ = (char)(offset + n);
    return p;
  }
  unsigned char tmp[sizeof(Py_ssize_t)];
  int lb = 0;
  Py_ssize_t l = n;
  while (l) { tmp[lb++] = (unsigned char)(l & 0xFF); l >>= 8; }
  if (end - p < 1 + lb) { set_err("RLP input resized during encode"); return NULL; }
  *p++ = (char)(offset + 55 + lb);
  for (int i = lb - 1; i >= 0; --i) *p++ = (char)tmp[i];
  return p;
}

static char *enc_write(PyObject *o, char *p, const char *end, int depth) {
  const char *buf;
  Py_ssize_t n;
  if (PyBytes_CheckExact(o)) {
    buf = PyBytes_AS_STRING(o);
    n = PyBytes_GET_SIZE(o);
  } else if (PyByteArray_CheckExact(o)) {
    buf = PyByteArray_AS_STRING(o);
    n = PyByteArray_GET_SIZE(o);
  } else {
    int is_list = PyList_CheckExact(o);
    Py_ssize_t k = is_list ? PyList_GET_SIZE(o) : PyTuple_GET_SIZE(o);
    Py_ssize_t total = 0;
    for (Py_ssize_t i = 0; i < k; ++i) {
      PyObject *c = is_list ? PyList_GET_ITEM(o, i) : PyTuple_GET_ITEM(o, i);
      Py_ssize_t s;
      if (enc_size(c, &s, depth + 1) < 0) return NULL;
      total += s;
    }
    p = write_len(p, end, total, 0xC0);
    if (p == NULL) return NULL;
    for (Py_ssize_t i = 0; i < k; ++i) {
      PyObject *c = is_list ? PyList_GET_ITEM(o, i) : PyTuple_GET_ITEM(o, i);
      p = enc_write(c, p, end, depth + 1);
      if (p == NULL) return NULL;
    }
    return p;
  }
  if (n == 1 && (unsigned char)buf[0] < 0x80) {
    if (end - p < 1) { set_err("RLP input resized during encode"); return NULL; }
    *p++ = buf[0];
    return p;
  }
  p = write_len(p, end, n, 0x80);
  if (p == NULL) return NULL;
  if (n > end - p) { set_err("RLP input resized during encode"); return NULL; }
  memcpy(p, buf, n);
  return p + n;
}

static PyObject *py_encode(PyObject *self, PyObject *o) {
  Py_ssize_t size;
  if (enc_size(o, &size, 0) < 0) return NULL;
  if (enc_hook != NULL) { /* test-only seam for the resize race */
    PyObject *r = PyObject_CallObject(enc_hook, NULL);
    if (!r) return NULL;
    Py_DECREF(r);
  }
  PyObject *out = PyBytes_FromStringAndSize(NULL, size);
  if (!out) return NULL;
  char *buf = PyBytes_AS_STRING(out);
  char *end = enc_write(o, buf, buf + size, 0);
  if (end == NULL) {
    Py_DECREF(out);
    return NULL;
  }
  if (end != buf + size) { /* shrank between passes */
    Py_DECREF(out);
    set_err("RLP input resized during encode");
    return NULL;
  }
  return out;
}

/* ------------------------------------------------------------ decode */

static PyObject *dec_at(const unsigned char *d, Py_ssize_t len,
                        Py_ssize_t pos, Py_ssize_t *end_out, int depth);

static PyObject *dec_list(const unsigned char *d, Py_ssize_t len,
                          Py_ssize_t start, Py_ssize_t end, int depth) {
  if (depth >= MAX_DEPTH) {
    set_err("RLP nesting exceeds MAX_DEPTH");
    return NULL;
  }
  PyObject *items = PyList_New(0);
  if (!items) return NULL;
  Py_ssize_t pos = start;
  while (pos < end) {
    Py_ssize_t next;
    PyObject *item = dec_at(d, len, pos, &next, depth + 1);
    if (!item) { Py_DECREF(items); return NULL; }
    if (next > end) {
      Py_DECREF(item);
      Py_DECREF(items);
      set_err("list element overruns list payload");
      return NULL;
    }
    if (PyList_Append(items, item) < 0) {
      Py_DECREF(item);
      Py_DECREF(items);
      return NULL;
    }
    Py_DECREF(item);
    pos = next;
  }
  return items;
}

static PyObject *dec_at(const unsigned char *d, Py_ssize_t len,
                        Py_ssize_t pos, Py_ssize_t *end_out, int depth) {
  if (pos >= len) {
    set_err("truncated RLP input");
    return NULL;
  }
  unsigned char b0 = d[pos];
  if (b0 < 0x80) {
    *end_out = pos + 1;
    return PyBytes_FromStringAndSize((const char *)d + pos, 1);
  }
  if (b0 <= 0xB7) { /* short string */
    Py_ssize_t n = b0 - 0x80;
    Py_ssize_t end = pos + 1 + n;
    if (end > len) { set_err("truncated string"); return NULL; }
    if (n == 1 && d[pos + 1] < 0x80) {
      set_err("non-canonical single byte");
      return NULL;
    }
    *end_out = end;
    return PyBytes_FromStringAndSize((const char *)d + pos + 1, n);
  }
  if (b0 <= 0xBF) { /* long string */
    Py_ssize_t ll = b0 - 0xB7;
    if (pos + 1 + ll > len) { set_err("truncated length"); return NULL; }
    Py_ssize_t n = 0;
    for (Py_ssize_t i = 0; i < ll; ++i) {
      if (n > (PY_SSIZE_T_MAX >> 8)) { set_err("length overflow"); return NULL; }
      n = (n << 8) | d[pos + 1 + i];
    }
    if (n < 56 || (ll > 1 && d[pos + 1] == 0)) {
      set_err("non-canonical length");
      return NULL;
    }
    Py_ssize_t start = pos + 1 + ll;
    /* n can be near PY_SSIZE_T_MAX: compare by subtraction, never
       compute start + n (signed overflow is UB) */
    if (n > len - start) { set_err("truncated string"); return NULL; }
    Py_ssize_t end = start + n;
    *end_out = end;
    return PyBytes_FromStringAndSize((const char *)d + start, n);
  }
  if (b0 <= 0xF7) { /* short list */
    Py_ssize_t n = b0 - 0xC0;
    Py_ssize_t end = pos + 1 + n;
    if (end > len) { set_err("truncated list"); return NULL; }
    PyObject *items = dec_list(d, len, pos + 1, end, depth);
    if (!items) return NULL;
    *end_out = end;
    return items;
  }
  /* long list */
  Py_ssize_t ll = b0 - 0xF7;
  if (pos + 1 + ll > len) { set_err("truncated length"); return NULL; }
  Py_ssize_t n = 0;
  for (Py_ssize_t i = 0; i < ll; ++i) {
    if (n > (PY_SSIZE_T_MAX >> 8)) { set_err("length overflow"); return NULL; }
    n = (n << 8) | d[pos + 1 + i];
  }
  if (n < 56 || (ll > 1 && d[pos + 1] == 0)) {
    set_err("non-canonical length");
    return NULL;
  }
  Py_ssize_t start = pos + 1 + ll;
  if (n > len - start) { set_err("truncated list"); return NULL; }
  Py_ssize_t end = start + n;
  PyObject *items = dec_list(d, len, start, end, depth);
  if (!items) return NULL;
  *end_out = end;
  return items;
}

static PyObject *py_decode(PyObject *self, PyObject *arg) {
  Py_buffer view;
  if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return NULL;
  Py_ssize_t end;
  PyObject *item =
      dec_at((const unsigned char *)view.buf, view.len, 0, &end, 0);
  if (item && end != view.len) {
    Py_DECREF(item);
    item = NULL;
    set_err("trailing bytes after RLP item");
  }
  PyBuffer_Release(&view);
  return item;
}

static PyObject *py_set_error(PyObject *self, PyObject *cls) {
  Py_XINCREF(cls);
  Py_XDECREF(rlp_error);
  rlp_error = cls;
  Py_RETURN_NONE;
}

static PyObject *py_set_encode_hook(PyObject *self, PyObject *cb) {
  /* Test-only: install a callable invoked between the size and write
   * passes of encode (None clears). Lets tests exercise the
   * resized-input guard deterministically. */
  if (cb == Py_None) cb = NULL;
  Py_XINCREF(cb);
  Py_XDECREF(enc_hook);
  enc_hook = cb;
  Py_RETURN_NONE;
}

/* -------------------------------------------------- snappy compress
 *
 * Greedy Snappy block-format compressor (the devp2p p2p/v5 frame
 * codec): a 16-bit hash table finds 4-byte matches within a 64 KiB
 * window; matches emit copy-with-2-byte-offset ops (<= 64 bytes per
 * op), gaps emit literals. Output is accepted by any spec decoder —
 * the Python decompress in network/snappy_codec.py round-trips it in
 * tests. Role parity: the reference links snappy-java (SURVEY §2.10).
 */

#define SNAPPY_HASH_BITS 14
#define SNAPPY_HASH_SIZE (1 << SNAPPY_HASH_BITS)

static inline uint32_t snappy_hash(const unsigned char *p) {
  uint32_t v = (uint32_t)p[0] | ((uint32_t)p[1] << 8) |
               ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
  return (v * 0x1E35A7BDu) >> (32 - SNAPPY_HASH_BITS);
}

static unsigned char *emit_literal(unsigned char *op,
                                   const unsigned char *base,
                                   Py_ssize_t len) {
  while (len > 0) {
    Py_ssize_t n = len;
    if (n > 65536) n = 65536; /* keep extended length <= 2 bytes */
    if (n <= 60) {
      *op++ = (unsigned char)((n - 1) << 2);
    } else if (n <= 256) {
      *op++ = 60 << 2;
      *op++ = (unsigned char)(n - 1);
    } else {
      *op++ = 61 << 2;
      *op++ = (unsigned char)((n - 1) & 0xFF);
      *op++ = (unsigned char)(((n - 1) >> 8) & 0xFF);
    }
    memcpy(op, base, n);
    op += n;
    base += n;
    len -= n;
  }
  return op;
}

static unsigned char *emit_copy(unsigned char *op, Py_ssize_t offset,
                                Py_ssize_t len) {
  /* copy2: 6-bit (len-1), 16-bit LE offset; split long matches */
  while (len > 0) {
    Py_ssize_t n = len;
    if (n > 64) n = 64;
    if (n < 4) break; /* never emit a <4-byte copy (tail folds into
                         the next literal) */
    *op++ = (unsigned char)(((n - 1) << 2) | 2);
    *op++ = (unsigned char)(offset & 0xFF);
    *op++ = (unsigned char)((offset >> 8) & 0xFF);
    len -= n;
  }
  return op;
}

static PyObject *py_snappy_compress(PyObject *self, PyObject *arg) {
  Py_buffer view;
  if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return NULL;
  const unsigned char *src = (const unsigned char *)view.buf;
  Py_ssize_t n = view.len;
  /* worst-case output bound (snappy's MaxCompressedLength formula):
     greedy emission can EXPAND — e.g. alternating short literal runs
     (2-3 header bytes each) with 4-byte copies that save only 1 — so
     the slack must scale with n/6, not per-64KiB */
  Py_ssize_t cap = 32 + n + n / 6;
  unsigned char *buf = (unsigned char *)PyMem_Malloc(cap < 16 ? 16 : cap);
  if (!buf) {
    PyBuffer_Release(&view);
    return PyErr_NoMemory();
  }
  unsigned char *op = buf;
  Py_ssize_t v = n;
  do { /* varint uncompressed length */
    unsigned char b = (unsigned char)(v & 0x7F);
    v >>= 7;
    *op++ = v ? (b | 0x80) : b;
  } while (v);

  uint16_t table[SNAPPY_HASH_SIZE];
  memset(table, 0, sizeof(table));
  /* table stores pos+1 within the current 64 KiB-aligned region, so a
     zero entry means empty; offsets are validated against the window */
  Py_ssize_t lit_start = 0;
  Py_ssize_t i = 0;
  while (i + 4 <= n) {
    uint32_t h = snappy_hash(src + i);
    Py_ssize_t cand = (Py_ssize_t)table[h] - 1 +
                      (i & ~(Py_ssize_t)0xFFFF);
    if (cand >= i) cand -= 65536;
    table[h] = (uint16_t)((i & 0xFFFF) + 1);
    if (cand >= 0 && cand < i && i - cand <= 65535 &&
        memcmp(src + cand, src + i, 4) == 0) {
      /* extend the match */
      Py_ssize_t len = 4;
      while (i + len < n && src[cand + len] == src[i + len] &&
             len < 65536)
        ++len;
      op = emit_literal(op, src + lit_start, i - lit_start);
      /* emit_copy splits at 64 and refuses a <4-byte tail — compute
         the coverable length so the tail folds into the next literal */
      Py_ssize_t covered = len - (len % 64);
      Py_ssize_t tail = len % 64;
      if (tail >= 4) covered += tail;
      op = emit_copy(op, i - cand, covered);
      i += covered;
      lit_start = i;
      continue;
    }
    ++i;
  }
  op = emit_literal(op, src + lit_start, n - lit_start);
  PyObject *out = PyBytes_FromStringAndSize((const char *)buf, op - buf);
  PyMem_Free(buf);
  PyBuffer_Release(&view);
  return out;
}

static PyMethodDef methods[] = {
    {"encode", py_encode, METH_O, "RLP-encode bytes / nested lists."},
    {"decode", py_decode, METH_O, "RLP-decode one item (strict)."},
    {"_set_error", py_set_error, METH_O, "Install the error class."},
    {"_set_encode_hook", py_set_encode_hook, METH_O,
     "Test-only: callable run between encode's size and write passes."},
    {"snappy_compress", py_snappy_compress, METH_O,
     "Greedy Snappy block-format compression."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "khipu_rlp_ext", NULL, -1, methods,
};

PyMODINIT_FUNC PyInit_khipu_rlp_ext(void) {
  return PyModule_Create(&moduledef);
}
