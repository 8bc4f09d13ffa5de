// CPython extension of dat_replication_protocol_tpu_torch: the decoder's
// change-run dispatch loop and the per-record Change codec in C.
//
// A trimmed copy of the JAX package's native/dat_fastpath.cpp.  The
// ctypes library (dat_native.cpp) indexes frames and pre-decodes change
// columns in bulk; what remains per frame is object construction, ack
// bookkeeping and the handler call.  This module moves everything but
// the handler call into C:
//
// * FastAck: a C callable with a lock-free state machine (std::atomic
//   exchange/CAS): the handler-returned vs done()-from-another-thread
//   race is settled by a single compare_exchange, with no lock on any
//   path.
// * AckBoard: one atomic outstanding-ack counter per decoder; armed
//   acks increment it, releases decrement, and the release that hits
//   zero calls dec._resume().  Decoder._stalled() consults it.
// * dispatch_changes(): the per-frame loop — slot-built Change objects
//   straight from the columnar numpy buffers, handler vectorcall, ack
//   arming, stall checks.
// * encode_change_c / decode_change_c: one Change to and from its
//   proto2 bytes, byte for byte and message for message the port's
//   Python codec (wire/change_codec.py).
//
// Not copied: bytes_spans, which serves only the JAX package's host
// hash engine (the port hashes on the card).  Three differences from the
// JAX package's copy: the module is named dat_torch_fastpath (a
// single-phase extension holds a sys.modules slot by its name, and one
// process may load both packages' extensions: under one name, reloading
// either copied its functions into the other); a change payload that
// fails UTF-8 in the dispatch loop leaves the exception object itself in
// st["decode_error"] (so the decoder's ProtocolError carries it as its
// cause); and decode_change_c's error messages are the port's Python
// codec's.
//
// Built at first use by runtime/fastpath.py (g++ against this
// interpreter's headers); a failed build raises.
//
// reference: decode.js:144-169 is the loop this accelerates.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <atomic>
#include <cstdint>
#include <cstring>

namespace {

// ack states
enum { FRESH = 0, SYNC_ACKED = 1, ARMED = 2 };

PyObject *s_pending, *s_paused, *s_destroyed, *s_changes, *s_resume;
PyObject *s_key, *s_change, *s_from, *s_to, *s_value, *s_subset;
PyObject *empty_bytes, *empty_str, *empty_tuple;

// ---------------------------------------------------------------------------
// AckBoard
// ---------------------------------------------------------------------------

typedef struct {
    PyObject_HEAD
    std::atomic<long> outstanding;
} AckBoard;

static PyObject *ackboard_new(PyTypeObject *type, PyObject *, PyObject *) {
    AckBoard *self = (AckBoard *)type->tp_alloc(type, 0);
    if (self != nullptr) self->outstanding.store(0);
    return (PyObject *)self;
}

static PyObject *ackboard_get_outstanding(AckBoard *self, void *) {
    return PyLong_FromLong(self->outstanding.load());
}

static PyGetSetDef ackboard_getset[] = {
    {"outstanding", (getter)ackboard_get_outstanding, nullptr,
     "armed (deferred) acks not yet released", nullptr},
    {nullptr, nullptr, nullptr, nullptr, nullptr},
};

static PyTypeObject AckBoard_Type = {
    PyVarObject_HEAD_INIT(nullptr, 0)
    "dat_torch_fastpath.AckBoard",            /* tp_name */
    sizeof(AckBoard),                   /* tp_basicsize */
};

// ---------------------------------------------------------------------------
// FastAck
// ---------------------------------------------------------------------------

typedef struct {
    PyObject_HEAD
    PyObject *dec;    // strong ref; needed for _resume on release
    PyObject *board;  // strong ref (AckBoard)
    std::atomic<int> state;
} FastAck;

static void fastack_dealloc(FastAck *self) {
    Py_XDECREF(self->dec);
    Py_XDECREF(self->board);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyObject *fastack_call(FastAck *self, PyObject *, PyObject *) {
    // one-shot: exactly one exchange can observe ARMED, so the release
    // runs at most once; double/late calls are no-ops
    int prev = self->state.exchange(SYNC_ACKED);
    if (prev == ARMED) {
        AckBoard *board = (AckBoard *)self->board;
        long left = board->outstanding.fetch_sub(1) - 1;
        if (left <= 0 && self->dec != nullptr) {
            PyObject *r = PyObject_CallMethodNoArgs(self->dec, s_resume);
            if (r == nullptr) return nullptr;  // propagate handler errors
            Py_DECREF(r);
        }
    }
    Py_RETURN_NONE;
}

static PyTypeObject FastAck_Type = {
    PyVarObject_HEAD_INIT(nullptr, 0)
    "dat_torch_fastpath.FastAck",             /* tp_name */
    sizeof(FastAck),                    /* tp_basicsize */
};

static FastAck *fastack_alloc(PyObject *dec, PyObject *board) {
    FastAck *ack = (FastAck *)FastAck_Type.tp_alloc(&FastAck_Type, 0);
    if (ack == nullptr) return nullptr;
    Py_INCREF(dec);
    ack->dec = dec;
    Py_INCREF(board);
    ack->board = board;
    ack->state.store(FRESH);
    return ack;
}

// ---------------------------------------------------------------------------
// dispatch_changes
// ---------------------------------------------------------------------------

struct View {
    Py_buffer buf{};
    bool held = false;
    int acquire(PyObject *obj) {
        if (PyObject_GetBuffer(obj, &buf, PyBUF_SIMPLE) < 0) return -1;
        held = true;
        return 0;
    }
    ~View() {
        if (held) PyBuffer_Release(&buf);
    }
};

static long get_long_attr(PyObject *o, PyObject *name, int *err) {
    PyObject *v = PyObject_GetAttr(o, name);
    if (v == nullptr) {
        *err = 1;
        return 0;
    }
    long r = PyLong_AsLong(v);
    Py_DECREF(v);
    if (r == -1 && PyErr_Occurred()) *err = 1;
    return r;
}

// Move a pending UnicodeDecodeError into st["decode_error"] (the
// exception object itself) and clear it; returns 0, or -1 when the
// pending error is something else (left set).
static int stash_decode_error(PyObject *st) {
    if (!PyErr_ExceptionMatches(PyExc_UnicodeDecodeError)) return -1;
    PyObject *t, *v, *tb;
    PyErr_Fetch(&t, &v, &tb);
    PyErr_NormalizeException(&t, &v, &tb);
    if (v != nullptr) {
        if (tb != nullptr) PyException_SetTraceback(v, tb);
        PyDict_SetItemString(st, "decode_error", v);
    }
    Py_XDECREF(t);
    Py_XDECREF(v);
    Py_XDECREF(tb);
    return 0;
}

// dispatch_changes(dec, board, cb_or_None, change_cls, buf,
//                  ids, chg, frm, tov, koff, klen, soff, slen, voff,
//                  vlen, f, row, n, st, starts, lens, sink_or_None)
// When ``sink`` is a list, each dispatched change's raw payload
// (buf[starts[f] : starts[f]+lens[f]]) is appended as bytes — the
// digest decoder's bulk tap; the caller submits them after the run.
// -> (new_f, new_row, status)  status: 0 ran to a non-change frame or
// n; 1 stalled (armed ack / destroy / pause / pending); 2 a change
// payload failed UTF-8 decoding — the UnicodeDecodeError is left in
// st["decode_error"] and NO Python exception is set, so the caller can
// destroy with ProtocolError without ever confusing a handler-raised
// ValueError for a wire error (handler exceptions propagate as real
// exceptions).  Progress is ALSO written into st["f"]/st["row"] before
// any error return, so a raising handler cannot desync the cursor.
static PyObject *dispatch_changes(PyObject *, PyObject *args) {
    PyObject *dec, *board_o, *cb, *cls_o, *buf_o, *ids_o;
    PyObject *chg_o, *frm_o, *tov_o, *koff_o, *klen_o, *soff_o, *slen_o,
        *voff_o, *vlen_o, *st;
    PyObject *starts_o = Py_None, *flens_o = Py_None, *sink_o = Py_None;
    Py_ssize_t f, row, n;
    if (!PyArg_ParseTuple(
            args, "OOOOOOOOOOOOOOOnnnO|OOO", &dec, &board_o, &cb, &cls_o,
            &buf_o, &ids_o, &chg_o, &frm_o, &tov_o, &koff_o, &klen_o,
            &soff_o, &slen_o, &voff_o, &vlen_o, &f, &row, &n, &st,
            &starts_o, &flens_o, &sink_o))
        return nullptr;
    const bool have_sink = (sink_o != Py_None);
    if (have_sink && (!PyList_CheckExact(sink_o) || starts_o == Py_None ||
                      flens_o == Py_None)) {
        PyErr_SetString(PyExc_TypeError,
                        "sink requires a list plus starts/lens buffers");
        return nullptr;
    }
    if (!PyObject_TypeCheck(board_o, &AckBoard_Type)) {
        PyErr_SetString(PyExc_TypeError, "board must be an AckBoard");
        return nullptr;
    }
    if (!PyDict_Check(st)) {
        PyErr_SetString(PyExc_TypeError, "st must be a dict");
        return nullptr;
    }
    AckBoard *board = (AckBoard *)board_o;
    PyTypeObject *cls = (PyTypeObject *)cls_o;
    const bool have_cb = (cb != Py_None);

    View v_buf, v_ids, v_chg, v_frm, v_tov, v_koff, v_klen, v_soff,
        v_slen, v_voff, v_vlen, v_starts, v_flens;
    if (v_buf.acquire(buf_o) < 0 || v_ids.acquire(ids_o) < 0 ||
        v_chg.acquire(chg_o) < 0 || v_frm.acquire(frm_o) < 0 ||
        v_tov.acquire(tov_o) < 0 || v_koff.acquire(koff_o) < 0 ||
        v_klen.acquire(klen_o) < 0 || v_soff.acquire(soff_o) < 0 ||
        v_slen.acquire(slen_o) < 0 || v_voff.acquire(voff_o) < 0 ||
        v_vlen.acquire(vlen_o) < 0)
        return nullptr;
    if (have_sink && (v_starts.acquire(starts_o) < 0 ||
                      v_flens.acquire(flens_o) < 0))
        return nullptr;
    const int64_t *fstarts =
        have_sink ? (const int64_t *)v_starts.buf.buf : nullptr;
    const int64_t *flens =
        have_sink ? (const int64_t *)v_flens.buf.buf : nullptr;
    const char *buf = (const char *)v_buf.buf.buf;
    const uint8_t *ids = (const uint8_t *)v_ids.buf.buf;
    const uint32_t *chg = (const uint32_t *)v_chg.buf.buf;
    const uint32_t *frm = (const uint32_t *)v_frm.buf.buf;
    const uint32_t *tov = (const uint32_t *)v_tov.buf.buf;
    const int64_t *koff = (const int64_t *)v_koff.buf.buf;
    const int64_t *klen = (const int64_t *)v_klen.buf.buf;
    const int64_t *soff = (const int64_t *)v_soff.buf.buf;
    const int64_t *slen = (const int64_t *)v_slen.buf.buf;
    const int64_t *voff = (const int64_t *)v_voff.buf.buf;
    const int64_t *vlen = (const int64_t *)v_vlen.buf.buf;

    int err = 0;
    long changes = get_long_attr(dec, s_changes, &err);
    if (err) return nullptr;

    int status = 0;
    bool exc = false;

    while (f < n && ids[f] == 1 /* TYPE_CHANGE */) {
        // --- build the Change ------------------------------------------
        PyObject *ch = cls->tp_new(cls, empty_tuple, nullptr);
        if (ch == nullptr) { exc = true; break; }
        PyObject *key = PyUnicode_DecodeUTF8(buf + koff[row],
                                             (Py_ssize_t)klen[row], nullptr);
        if (key == nullptr) {
            Py_DECREF(ch);
            if (stash_decode_error(st) == 0) {
                status = 2;
                break;
            }
            exc = true;
            break;
        }
        PyObject *val;
        if (vlen[row] >= 0) {
            val = PyBytes_FromStringAndSize(buf + voff[row],
                                            (Py_ssize_t)vlen[row]);
        } else {
            val = empty_bytes;
            Py_INCREF(val);
        }
        PyObject *sub;
        if (slen[row] >= 0) {
            sub = PyUnicode_DecodeUTF8(buf + soff[row],
                                       (Py_ssize_t)slen[row], nullptr);
            if (sub == nullptr && stash_decode_error(st) == 0) {
                Py_DECREF(ch);
                Py_DECREF(key);
                Py_XDECREF(val);
                status = 2;
                break;
            }
        } else {
            sub = empty_str;
            Py_INCREF(sub);
        }
        PyObject *cg = PyLong_FromUnsignedLong(chg[row]);
        PyObject *fr = PyLong_FromUnsignedLong(frm[row]);
        PyObject *to = PyLong_FromUnsignedLong(tov[row]);
        int bad = (val == nullptr || sub == nullptr || cg == nullptr ||
                   fr == nullptr || to == nullptr);
        if (!bad) {
            bad = PyObject_SetAttr(ch, s_key, key) < 0 ||
                  PyObject_SetAttr(ch, s_change, cg) < 0 ||
                  PyObject_SetAttr(ch, s_from, fr) < 0 ||
                  PyObject_SetAttr(ch, s_to, to) < 0 ||
                  PyObject_SetAttr(ch, s_value, val) < 0 ||
                  PyObject_SetAttr(ch, s_subset, sub) < 0;
        }
        Py_DECREF(key);
        Py_XDECREF(val);
        Py_XDECREF(sub);
        Py_XDECREF(cg);
        Py_XDECREF(fr);
        Py_XDECREF(to);
        if (bad) { Py_DECREF(ch); exc = true; break; }

        if (have_sink) {
            PyObject *pl = PyBytes_FromStringAndSize(
                buf + fstarts[f], (Py_ssize_t)flens[f]);
            if (pl == nullptr || PyList_Append(sink_o, pl) < 0) {
                Py_XDECREF(pl);
                Py_DECREF(ch);
                exc = true;
                break;
            }
            Py_DECREF(pl);
        }
        row += 1;
        f += 1;
        changes += 1;
        // counter visible inside the handler, as _deliver_change sets it
        {
            PyObject *cv = PyLong_FromLong(changes);
            if (cv == nullptr || PyObject_SetAttr(dec, s_changes, cv) < 0) {
                Py_XDECREF(cv);
                Py_DECREF(ch);
                exc = true;
                break;
            }
            Py_DECREF(cv);
        }

        if (have_cb) {
            FastAck *ack = fastack_alloc(dec, board_o);
            if (ack == nullptr) { Py_DECREF(ch); exc = true; break; }
            PyObject *argv[2] = {ch, (PyObject *)ack};
            PyObject *r = PyObject_Vectorcall(cb, argv, 2, nullptr);
            Py_DECREF(ch);
            if (r == nullptr) {
                Py_DECREF(ack);
                exc = true;
                break;
            }
            Py_DECREF(r);
            // arm iff the handler did NOT ack synchronously.  The CAS
            // settles the cross-thread race: a done() landing between
            // the handler returning and this point flips state to
            // SYNC_ACKED and the CAS fails -> sync path.
            int expected = FRESH;
            if (ack->state.compare_exchange_strong(expected, ARMED)) {
                board->outstanding.fetch_add(1);
                Py_DECREF(ack);
                status = 1;
                break;  // park: the armed release resumes the decoder
            }
            Py_DECREF(ack);
        } else {
            Py_DECREF(ch);  // no handler: drop (reference: decode.js:54-56)
        }

        // destroy / pause / pending checks (a handler may destroy the
        // decoder or pause an earlier blob reader mid-run)
        PyObject *d = PyObject_GetAttr(dec, s_destroyed);
        if (d == nullptr) { exc = true; break; }
        int is_destroyed = PyObject_IsTrue(d);
        Py_DECREF(d);
        if (is_destroyed < 0) { exc = true; break; }
        if (is_destroyed) { status = 1; break; }
        long paused = get_long_attr(dec, s_paused, &err);
        if (err) { exc = true; break; }
        long pending = get_long_attr(dec, s_pending, &err);
        if (err) { exc = true; break; }
        if (paused > 0 || pending > 0 || board->outstanding.load() > 0) {
            status = 1;
            break;
        }
    }

    // progress writeback happens even on error: a raising handler must
    // not desync the cursor from the delivered rows
    PyObject *fv = PyLong_FromSsize_t(f);
    PyObject *rv = PyLong_FromSsize_t(row);
    if (fv != nullptr && rv != nullptr) {
        if (exc) {
            // preserve the pending exception across the dict stores
            PyObject *t, *val2, *tb;
            PyErr_Fetch(&t, &val2, &tb);
            PyDict_SetItemString(st, "f", fv);
            PyDict_SetItemString(st, "row", rv);
            PyErr_Restore(t, val2, tb);
        } else {
            PyDict_SetItemString(st, "f", fv);
            PyDict_SetItemString(st, "row", rv);
        }
    }
    Py_XDECREF(fv);
    Py_XDECREF(rv);
    if (exc) return nullptr;
    return Py_BuildValue("nni", f, row, status);
}


// ---------------------------------------------------------------------------
// encode_change_c — proto2 serialization of one Change (the
// wire/change_codec.py encoder's native route; byte-identical)
// ---------------------------------------------------------------------------

static inline int uvarint_len(uint64_t v) {
    int n = 1;
    while (v >= 0x80) { v >>= 7; n++; }
    return n;
}

static inline int put_uvarint(uint8_t *p, uint64_t v) {
    int i = 0;
    while (v >= 0x80) { p[i++] = (uint8_t)(v | 0x80); v >>= 7; }
    p[i++] = (uint8_t)v;
    return i;
}

static int as_uint32(PyObject *o, const char *name, uint32_t *out) {
    // mirror change_codec._check_uint32: int (incl. bool) in [0, 2^32)
    int overflow = 0;
    long long v = -1;
    if (PyLong_Check(o)) {
        v = PyLong_AsLongLongAndOverflow(o, &overflow);
        if (v == -1 && PyErr_Occurred()) return -1;
    }
    if (!PyLong_Check(o) || overflow || v < 0 ||
        v > (long long)0xFFFFFFFFLL) {
        PyObject *r = PyObject_Repr(o);
        if (r == nullptr) return -1;
        PyErr_Format(PyExc_ValueError, "Change.%s must be a uint32, got %U",
                     name, r);
        Py_DECREF(r);
        return -1;
    }
    *out = (uint32_t)v;
    return 0;
}

// encode_change_c(key, change, from_, to, value_or_None, subset_or_None)
// -> bytes   (proto2 tags 0x0A subset / 0x12 key / 0x18 / 0x20 / 0x28 /
// 0x32 value, ascending field order, absent optionals omitted)
static PyObject *encode_change_c(PyObject *, PyObject *args) {
    PyObject *key_o, *cg_o, *fr_o, *to_o, *val_o, *sub_o;
    if (!PyArg_ParseTuple(args, "OOOOOO", &key_o, &cg_o, &fr_o, &to_o,
                          &val_o, &sub_o))
        return nullptr;
    uint32_t cg, fr, to;
    Py_ssize_t sub_n = 0, key_n = 0, val_n = 0;
    const char *sub_p = nullptr, *key_p = nullptr;
    if (sub_o != Py_None) {
        sub_p = PyUnicode_AsUTF8AndSize(sub_o, &sub_n);
        if (sub_p == nullptr) return nullptr;
    }
    if (key_o == Py_None) {
        PyErr_SetString(PyExc_ValueError, "Change.key is required");
        return nullptr;
    }
    key_p = PyUnicode_AsUTF8AndSize(key_o, &key_n);
    if (key_p == nullptr) return nullptr;
    if (as_uint32(cg_o, "change", &cg) < 0 ||
        as_uint32(fr_o, "from", &fr) < 0 ||
        as_uint32(to_o, "to", &to) < 0)
        return nullptr;
    Py_buffer val_view{};
    bool have_val = (val_o != Py_None);
    if (have_val) {
        if (PyObject_GetBuffer(val_o, &val_view, PyBUF_SIMPLE) < 0)
            return nullptr;
        val_n = val_view.len;
    }

    Py_ssize_t total = 0;
    if (sub_p) total += 1 + uvarint_len(sub_n) + sub_n;
    total += 1 + uvarint_len(key_n) + key_n;
    total += 1 + uvarint_len(cg) + 1 + uvarint_len(fr) + 1 + uvarint_len(to);
    if (have_val) total += 1 + uvarint_len(val_n) + val_n;

    PyObject *out = PyBytes_FromStringAndSize(nullptr, total);
    if (out == nullptr) {
        if (have_val) PyBuffer_Release(&val_view);
        return nullptr;
    }
    uint8_t *p = (uint8_t *)PyBytes_AS_STRING(out);
    if (sub_p) {
        *p++ = 0x0A;
        p += put_uvarint(p, sub_n);
        memcpy(p, sub_p, sub_n);
        p += sub_n;
    }
    *p++ = 0x12;
    p += put_uvarint(p, key_n);
    memcpy(p, key_p, key_n);
    p += key_n;
    *p++ = 0x18; p += put_uvarint(p, cg);
    *p++ = 0x20; p += put_uvarint(p, fr);
    *p++ = 0x28; p += put_uvarint(p, to);
    if (have_val) {
        *p++ = 0x32;
        p += put_uvarint(p, val_n);
        memcpy(p, val_view.buf, val_n);
        p += val_n;
        PyBuffer_Release(&val_view);
    }
    return out;
}


// ---------------------------------------------------------------------------
// decode_change_c — one proto2 Change payload -> a Change object (the
// streaming scanner's per-frame decoder; semantics and messages of
// wire/change_codec.py's Python parser, incl. uint32 truncation and
// unknown-field skipping; all malformed input -> ValueError)
// ---------------------------------------------------------------------------

// change_codec's wrapping of a truncation: ValueError("corrupt Change
// payload: <what>") raised from NeedMoreData("<what>") (``nmd``, the
// port's wire.varint.NeedMoreData, or None for no cause)
static void set_truncated(PyObject *nmd, const char *what) {
    if (nmd == nullptr || nmd == Py_None) {
        PyErr_Format(PyExc_ValueError, "corrupt Change payload: %s", what);
        return;
    }
    PyObject *inner = PyObject_CallFunction(nmd, "s", what);
    if (inner == nullptr) return;
    PyObject *outer = PyObject_CallFunction(
        PyExc_ValueError, "N",
        PyUnicode_FromFormat("corrupt Change payload: %s", what));
    if (outer == nullptr) {
        Py_DECREF(inner);
        return;
    }
    PyException_SetContext(outer, Py_NewRef(inner));  // steals
    PyException_SetCause(outer, inner);               // steals
    PyErr_SetObject(PyExc_ValueError, outer);
    Py_DECREF(outer);
}

// wire/varint.py decode_uvarint, with change_codec's wrapping of its
// truncation: "corrupt Change payload: truncated varint"
static int read_uvarint(const uint8_t *p, Py_ssize_t n, Py_ssize_t *i,
                        uint64_t *out, PyObject *nmd) {
    uint64_t v = 0;
    for (int k = 0;; ++k) {
        if (*i >= n) {
            set_truncated(nmd, "truncated varint");
            return -1;
        }
        uint8_t b = p[(*i)++];
        if (!(b & 0x80)) {
            if (k == 9 && (b & 0x7F) > 1) {
                PyErr_SetString(PyExc_ValueError, "varint exceeds 64 bits");
                return -1;
            }
            v |= (uint64_t)(b & 0x7F) << (7 * k);
            *out = v;
            return 0;
        }
        if (k < 9) v |= (uint64_t)(b & 0x7F) << (7 * k);
        if (k + 1 >= 10) {  // wire: MAX_VARINT_LEN = 10
            PyErr_SetString(PyExc_ValueError,
                            "varint too long (corrupt frame header)");
            return -1;
        }
    }
}

// decode_change_c(change_cls, payload_buffer[, need_more_data]) -> Change
static PyObject *decode_change_c(PyObject *, PyObject *args) {
    PyObject *cls_o, *buf_o, *nmd = Py_None;
    if (!PyArg_ParseTuple(args, "OO|O", &cls_o, &buf_o, &nmd))
        return nullptr;
    PyTypeObject *cls = (PyTypeObject *)cls_o;
    View v;
    if (v.acquire(buf_o) < 0) return nullptr;
    const uint8_t *p = (const uint8_t *)v.buf.buf;
    Py_ssize_t n = v.buf.len;
    Py_ssize_t i = 0;

    PyObject *key = nullptr, *value = nullptr, *subset = nullptr;
    uint32_t cg = 0, fr = 0, to = 0;
    bool have_cg = false, have_fr = false, have_to = false;

    while (i < n) {
        uint64_t tag;
        if (read_uvarint(p, n, &i, &tag, nmd) < 0) goto fail;
        switch (tag & 7) {
            case 0: {  // varint; uint32 truncates wider values
                uint64_t val;
                if (read_uvarint(p, n, &i, &val, nmd) < 0) goto fail;
                if (tag == 0x18) { cg = (uint32_t)val; have_cg = true; }
                else if (tag == 0x20) { fr = (uint32_t)val; have_fr = true; }
                else if (tag == 0x28) { to = (uint32_t)val; have_to = true; }
                break;
            }
            case 2: {  // length-delimited
                uint64_t ln;
                if (read_uvarint(p, n, &i, &ln, nmd) < 0) goto fail;
                if ((uint64_t)(n - i) < ln) {
                    set_truncated(nmd, "truncated length-delimited field");
                    goto fail;
                }
                if (tag == 0x12) {
                    Py_XDECREF(key);
                    // a UnicodeDecodeError IS a ValueError: it
                    // propagates as the Python parser's does
                    key = PyUnicode_DecodeUTF8((const char *)p + i,
                                               (Py_ssize_t)ln, nullptr);
                    if (key == nullptr) goto fail;
                } else if (tag == 0x0A) {
                    Py_XDECREF(subset);
                    subset = PyUnicode_DecodeUTF8((const char *)p + i,
                                                  (Py_ssize_t)ln, nullptr);
                    if (subset == nullptr) goto fail;
                } else if (tag == 0x32) {
                    Py_XDECREF(value);
                    value = PyBytes_FromStringAndSize((const char *)p + i,
                                                      (Py_ssize_t)ln);
                    if (value == nullptr) goto fail;
                }
                i += (Py_ssize_t)ln;
                break;
            }
            case 5:  // fixed32 (unknown field skip)
                if (n - i < 4) {
                    set_truncated(nmd, "truncated fixed32 field");
                    goto fail;
                }
                i += 4;
                break;
            case 1:  // fixed64 (unknown field skip)
                if (n - i < 8) {
                    set_truncated(nmd, "truncated fixed64 field");
                    goto fail;
                }
                i += 8;
                break;
            default:
                PyErr_Format(PyExc_ValueError,
                             "unsupported protobuf wire type %d",
                             (int)(tag & 7));
                goto fail;
        }
    }
    if (key == nullptr || !have_cg || !have_fr || !have_to) {
        PyErr_SetString(PyExc_ValueError,
                        "Change payload missing required fields");
        goto fail;
    }
    {
        PyObject *ch = cls->tp_new(cls, empty_tuple, nullptr);
        if (ch == nullptr) goto fail;
        PyObject *cgo = PyLong_FromUnsignedLong(cg);
        PyObject *fro = PyLong_FromUnsignedLong(fr);
        PyObject *too = PyLong_FromUnsignedLong(to);
        if (value == nullptr) { value = empty_bytes; Py_INCREF(value); }
        if (subset == nullptr) { subset = empty_str; Py_INCREF(subset); }
        int bad = (cgo == nullptr || fro == nullptr || too == nullptr);
        if (!bad) {
            bad = PyObject_SetAttr(ch, s_key, key) < 0 ||
                  PyObject_SetAttr(ch, s_change, cgo) < 0 ||
                  PyObject_SetAttr(ch, s_from, fro) < 0 ||
                  PyObject_SetAttr(ch, s_to, too) < 0 ||
                  PyObject_SetAttr(ch, s_value, value) < 0 ||
                  PyObject_SetAttr(ch, s_subset, subset) < 0;
        }
        Py_XDECREF(cgo);
        Py_XDECREF(fro);
        Py_XDECREF(too);
        Py_DECREF(key);
        Py_DECREF(value);
        Py_DECREF(subset);
        if (bad) { Py_DECREF(ch); return nullptr; }
        return ch;
    }
fail:
    Py_XDECREF(key);
    Py_XDECREF(value);
    Py_XDECREF(subset);
    return nullptr;
}

static PyMethodDef module_methods[] = {
    {"dispatch_changes", dispatch_changes, METH_VARARGS,
     "Dispatch a run of change frames from columnar buffers."},
    {"encode_change_c", encode_change_c, METH_VARARGS,
     "Serialize one Change to proto2 bytes (byte-identical to "
     "wire.change_codec.encode_change(native=False))."},
    {"decode_change_c", decode_change_c, METH_VARARGS,
     "Parse one proto2 Change payload into a Change object "
     "(semantics of wire.change_codec.decode_change(native=False)); a "
     "truncation raises ValueError from need_more_data when given."},
    {nullptr, nullptr, 0, nullptr},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "dat_torch_fastpath",
    "C dispatch loop and Change codec of the port's decoder.", -1,
    module_methods, nullptr, nullptr, nullptr, nullptr,
};

}  // namespace

PyMODINIT_FUNC PyInit_dat_torch_fastpath(void) {
    s_pending = PyUnicode_InternFromString("_pending");
    s_paused = PyUnicode_InternFromString("_paused_readers");
    s_destroyed = PyUnicode_InternFromString("destroyed");
    s_changes = PyUnicode_InternFromString("changes");
    s_resume = PyUnicode_InternFromString("_resume");
    s_key = PyUnicode_InternFromString("key");
    s_change = PyUnicode_InternFromString("change");
    s_from = PyUnicode_InternFromString("from_");
    s_to = PyUnicode_InternFromString("to");
    s_value = PyUnicode_InternFromString("value");
    s_subset = PyUnicode_InternFromString("subset");
    empty_bytes = PyBytes_FromStringAndSize(nullptr, 0);
    empty_str = PyUnicode_FromString("");
    empty_tuple = PyTuple_New(0);
    if (s_pending == nullptr || s_paused == nullptr ||
        s_destroyed == nullptr || s_changes == nullptr ||
        s_resume == nullptr || s_key == nullptr || s_change == nullptr ||
        s_from == nullptr || s_to == nullptr || s_value == nullptr ||
        s_subset == nullptr || empty_bytes == nullptr ||
        empty_str == nullptr || empty_tuple == nullptr)
        return nullptr;

    AckBoard_Type.tp_flags = Py_TPFLAGS_DEFAULT;
    AckBoard_Type.tp_new = ackboard_new;
    AckBoard_Type.tp_getset = ackboard_getset;
    if (PyType_Ready(&AckBoard_Type) < 0) return nullptr;

    FastAck_Type.tp_flags = Py_TPFLAGS_DEFAULT;
    FastAck_Type.tp_dealloc = (destructor)fastack_dealloc;
    FastAck_Type.tp_call = (ternaryfunc)fastack_call;
    if (PyType_Ready(&FastAck_Type) < 0) return nullptr;

    PyObject *m = PyModule_Create(&moduledef);
    if (m == nullptr) return nullptr;
    Py_INCREF(&AckBoard_Type);
    if (PyModule_AddObject(m, "AckBoard", (PyObject *)&AckBoard_Type) < 0) {
        Py_DECREF(&AckBoard_Type);
        Py_DECREF(m);
        return nullptr;
    }
    Py_INCREF(&FastAck_Type);
    if (PyModule_AddObject(m, "FastAck", (PyObject *)&FastAck_Type) < 0) {
        Py_DECREF(&FastAck_Type);
        Py_DECREF(m);
        return nullptr;
    }
    return m;
}
