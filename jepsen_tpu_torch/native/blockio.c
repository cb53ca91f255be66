/* blockio: CRC32-tracked positioned block writes for the run.jepsen
 * format.
 *
 * The native sibling of jepsen_tpu_torch/store/format.py's block framing — the
 * role the reference implements in Java (jepsen/src/jepsen/store/
 * FileOffsetOutputStream.java: an output stream over a FileChannel at an
 * offset, tracking CRC32).  A CPython extension rather than a subprocess:
 * the hot path is appending multi-megabyte packed history chunks, where
 * Python-level crc32+write costs two extra buffer traversals.
 *
 * Exposes:
 *   append_block(fd, type, payload) -> (offset, total_len)
 *       write [u32 len | u32 crc32 | u8 type | payload] at EOF
 *   crc32(payload) -> u32
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdint.h>
#include <string.h>
#include <unistd.h>

/* CRC-32 (IEEE 802.3, zlib-compatible), slice-by-1 with a lazily built
 * table — matching Python's zlib.crc32 so files stay interchangeable
 * between the C and Python writers. */
static uint32_t crc_table[256];
static int crc_table_ready = 0;

static void build_crc_table(void) {
  uint32_t c;
  int n, k;
  for (n = 0; n < 256; n++) {
    c = (uint32_t)n;
    for (k = 0; k < 8; k++)
      c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[n] = c;
  }
  crc_table_ready = 1;
}

static uint32_t crc32_buf(const unsigned char *buf, Py_ssize_t len) {
  uint32_t c = 0xFFFFFFFFu;
  Py_ssize_t i;
  if (!crc_table_ready)
    build_crc_table();
  for (i = 0; i < len; i++)
    c = crc_table[(c ^ buf[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

static int write_all(int fd, const unsigned char *buf, Py_ssize_t len) {
  while (len > 0) {
    ssize_t w = write(fd, buf, (size_t)len);
    if (w < 0) {
      if (errno == EINTR)
        continue;
      return -1;
    }
    buf += w;
    len -= w;
  }
  return 0;
}

static PyObject *py_crc32(PyObject *self, PyObject *args) {
  Py_buffer view;
  uint32_t c;
  if (!PyArg_ParseTuple(args, "y*", &view))
    return NULL;
  c = crc32_buf((const unsigned char *)view.buf, view.len);
  PyBuffer_Release(&view);
  return PyLong_FromUnsignedLong((unsigned long)c);
}

static PyObject *py_append_block(PyObject *self, PyObject *args) {
  int fd, btype;
  Py_buffer view;
  unsigned char header[9];
  uint32_t crc;
  off_t off;
  PyObject *result = NULL;

  if (!PyArg_ParseTuple(args, "iiy*", &fd, &btype, &view))
    return NULL;
  if (view.len > 0xFFFFFFFFLL - 9) {
    PyBuffer_Release(&view);
    PyErr_SetString(PyExc_ValueError, "payload too large for a u32-framed block");
    return NULL;
  }
  crc = crc32_buf((const unsigned char *)view.buf, view.len);
  header[0] = (unsigned char)(view.len & 0xFF);
  header[1] = (unsigned char)((view.len >> 8) & 0xFF);
  header[2] = (unsigned char)((view.len >> 16) & 0xFF);
  header[3] = (unsigned char)((view.len >> 24) & 0xFF);
  header[4] = (unsigned char)(crc & 0xFF);
  header[5] = (unsigned char)((crc >> 8) & 0xFF);
  header[6] = (unsigned char)((crc >> 16) & 0xFF);
  header[7] = (unsigned char)((crc >> 24) & 0xFF);
  header[8] = (unsigned char)(btype & 0xFF);

  Py_BEGIN_ALLOW_THREADS
  off = lseek(fd, 0, SEEK_END);
  if (off >= 0)
    if (write_all(fd, header, 9) != 0 ||
        write_all(fd, (const unsigned char *)view.buf, view.len) != 0)
      off = -2;
  Py_END_ALLOW_THREADS

  if (off == -1) {
    PyErr_SetFromErrno(PyExc_OSError);
  } else if (off == -2) {
    PyErr_SetFromErrno(PyExc_OSError);
  } else {
    result = Py_BuildValue("Ln", (long long)off, view.len);
  }
  PyBuffer_Release(&view);
  return result;
}

static PyMethodDef methods[] = {
    {"crc32", py_crc32, METH_VARARGS, "zlib-compatible CRC-32 of a buffer"},
    {"append_block", py_append_block, METH_VARARGS,
     "append_block(fd, type, payload) -> (offset, payload_len)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_blockio",
    "CRC32-tracked block appends for the run.jepsen format", -1, methods,
};

PyMODINIT_FUNC PyInit__blockio(void) { return PyModule_Create(&moduledef); }
