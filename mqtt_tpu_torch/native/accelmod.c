/* mqtt_torch_accel — the port's copy of the JAX package's C materializer
 * (native/accelmod.c), the CPython extension for the broker's hottest host
 * loop: materializing device match results into Subscribers objects.
 *
 * The device matcher (ops/flat.py) returns per-topic sid RANGES packed as
 * one int32 array [B, 2P+2] = (P range starts | P range counts | total |
 * overflow), or a compacted topic-major sid stream. The host must expand
 * each row into a Subscribers result —
 * per-client Subscription merges, shared groups keyed on the group filter,
 * inline subscriptions keyed on identifier — value-identical to the host
 * trie gather (reference gatherSubscriptions, topics.go:631-678).
 *
 * Pure-Python expansion caps the pipeline at the CPython allocation floor
 * no matter how fast the device kernel runs. This module performs the
 * same expansion through the C API,
 * exploiting the slots layout of the result types (packets.Subscription,
 * topics.Subscribers are `slots` classes): a per-type descriptor-offset
 * table is read once from the class's member descriptors, after which a
 * subscription copy is tp_alloc + N pointer moves and a Subscribers
 * result is tp_alloc + three dict stores. Classes without a usable slots
 * layout (exotic subclasses) transparently fall back to calling the
 * Python methods, so semantics never depend on layout.
 *
 * The semantics are pinned by differential tests
 * (tests/test_torch_native.py) against ops/matcher.expand_sids, which
 * remains the readable source of truth.
 *
 * Departures from the JAX package's copy, each marked "Port:" where it
 * applies:
 *  - the module is named mqtt_torch_accel (PyInit_ and tp_names), so it
 *    and the JAX package's mqtt_accel load in one process;
 *  - the tenant namespace guards: every entry point takes the topics'
 *    ns_guard_mode (a per-topic int8 buffer, or one int for a single
 *    topic) and drops each sid whose entry's guard class g has
 *    0 < g <= mode before it merges, as ops/matcher.expand_sids does; a
 *    view applies it in materialize(), targets(), len, has_shared and
 *    has_inline. The JAX package's materializer has no guard;
 *  - view_stats() also counts which path built each result and each
 *    copy.
 *
 * Contract notes mirrored from expand_sids:
 *  - a client's first sighting takes Subscription.self_merged_copy(): a
 *    fresh instance with the identifiers map materialized ({filter: id}
 *    when absent) or shared-and-extended (ids[filter] = id when id > 0 —
 *    mutating the SHARED map, exactly like Subscription.merge);
 *  - later sightings call prev.merge(sub) — the Python method, so any
 *    subclass override keeps winning;
 *  - shared entries are NOT copied: the group dict references the stored
 *    subscription (host gather does the same, topics.go:651-666);
 *  - inline entries key on the subscription identifier;
 *  - out-of-range sids are skipped (host parity: expand_sids bounds-checks
 *    against the sid space).
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <structmember.h>
#include <stdint.h>

#ifndef Py_T_OBJECT_EX
#define Py_T_OBJECT_EX T_OBJECT_EX
#endif

/* 3.11+ managed-dict flag: on older CPython no type carries it, so 0 is
 * the correct "flag never set" value — without this guard the module
 * silently failed to COMPILE on 3.10 and every caller fell back to the
 * slow Python materializer (caught by the C analysis gate, make c-gate) */
#ifndef Py_TPFLAGS_MANAGED_DICT
#define Py_TPFLAGS_MANAGED_DICT 0
#endif

/* interned attribute / key names (module-lifetime references) */
static PyObject *s_merge, *s_filter, *s_identifier, *s_identifiers;
static PyObject *s_subscriptions, *s_shared, *s_shared_selected;
static PyObject *s_inline_subscriptions, *s_self_merged_copy;

/* ---------------------------------------------------------------------- */
/* per-type slot layouts, read once from the class's member descriptors   */

#define MAX_SLOTS 32
#define MAX_LAYOUTS 8

typedef struct {
    PyTypeObject *tp;
    int ok;                 /* slot fast path usable for this type */
    int n;                  /* number of object slots */
    Py_ssize_t offs[MAX_SLOTS];
    Py_ssize_t ids_off, filter_off, ident_off; /* -1 when absent */
} SubLayout;

typedef struct {
    PyTypeObject *tp;
    int ok;
    Py_ssize_t subscriptions_off, shared_off, shared_selected_off,
        inline_off;
} ResLayout;

static SubLayout sub_layouts[MAX_LAYOUTS];
static int n_sub_layouts;
static ResLayout res_layouts[MAX_LAYOUTS];
static int n_res_layouts;

/* Collect every Py_T_OBJECT_EX member descriptor reachable through the
 * MRO. Returns the count, or -1 when the type cannot take the fast path
 * (instance dict present, too many slots, or non-object members). */
static int
collect_object_slots(PyTypeObject *tp, Py_ssize_t *offs, int max,
                     Py_ssize_t *named_offs[], PyObject *named[], int n_named)
{
    /* an instance dict can carry attributes a slot copy would miss */
    if (tp->tp_dictoffset != 0 ||
        (tp->tp_flags & Py_TPFLAGS_MANAGED_DICT))
        return -1;
    PyObject *mro = tp->tp_mro;
    if (mro == NULL || !PyTuple_Check(mro))
        return -1;
    int n = 0;
    for (Py_ssize_t m = 0; m < PyTuple_GET_SIZE(mro); m++) {
        PyObject *base = PyTuple_GET_ITEM(mro, m);
        if (!PyType_Check(base))
            continue;
        PyObject *dict = ((PyTypeObject *)base)->tp_dict;
        if (dict == NULL)
            continue;
        PyObject *key, *value;
        Py_ssize_t pos = 0;
        while (PyDict_Next(dict, &pos, &key, &value)) {
            if (!Py_IS_TYPE(value, &PyMemberDescr_Type))
                continue;
            PyMemberDef *def = ((PyMemberDescrObject *)value)->d_member;
            if (def == NULL)
                continue;
            if (def->type != Py_T_OBJECT_EX && def->type != T_OBJECT_EX)
                return -1; /* non-object slot: no generic pointer copy */
            int dup = 0; /* a subclass may shadow a base slot name */
            for (int i = 0; i < n; i++)
                if (offs[i] == def->offset) {
                    dup = 1;
                    break;
                }
            if (dup)
                continue;
            if (n >= max)
                return -1;
            offs[n++] = def->offset;
            for (int k = 0; k < n_named; k++) {
                int eq = PyObject_RichCompareBool(key, named[k], Py_EQ);
                if (eq < 0)
                    return -1;
                /* MRO runs subclass-first: record the offset only while
                 * it is still unset, so a subclass slot that shadows a
                 * base-class slot of the same name wins — matching
                 * Python attribute lookup. (The shadowed base slot has
                 * its own, never-written offset; reading it would
                 * silently yield NULL.) */
                if (eq && *named_offs[k] == -1)
                    *named_offs[k] = def->offset;
            }
        }
    }
    return n;
}

static SubLayout *
sub_layout_for(PyTypeObject *tp)
{
    for (int i = 0; i < n_sub_layouts; i++)
        if (sub_layouts[i].tp == tp)
            return &sub_layouts[i];
    if (n_sub_layouts >= MAX_LAYOUTS)
        return NULL; /* caller falls back to the Python method */
    SubLayout *L = &sub_layouts[n_sub_layouts];
    L->tp = tp;
    L->ids_off = L->filter_off = L->ident_off = -1;
    Py_ssize_t *named_offs[3] = {&L->ids_off, &L->filter_off, &L->ident_off};
    PyObject *named[3] = {s_identifiers, s_filter, s_identifier};
    int n = collect_object_slots(tp, L->offs, MAX_SLOTS, named_offs, named, 3);
    if (PyErr_Occurred())
        PyErr_Clear();
    L->n = n > 0 ? n : 0;
    L->ok = (n > 0 && L->ids_off >= 0 && L->filter_off >= 0 &&
             L->ident_off >= 0);
    n_sub_layouts++;
    return L;
}

static ResLayout *
res_layout_for(PyTypeObject *tp)
{
    for (int i = 0; i < n_res_layouts; i++)
        if (res_layouts[i].tp == tp)
            return &res_layouts[i];
    if (n_res_layouts >= MAX_LAYOUTS)
        return NULL;
    ResLayout *L = &res_layouts[n_res_layouts];
    L->tp = tp;
    L->subscriptions_off = L->shared_off = L->shared_selected_off =
        L->inline_off = -1;
    Py_ssize_t dummy[MAX_SLOTS];
    Py_ssize_t *named_offs[4] = {&L->subscriptions_off, &L->shared_off,
                                 &L->shared_selected_off, &L->inline_off};
    PyObject *named[4] = {s_subscriptions, s_shared, s_shared_selected,
                          s_inline_subscriptions};
    int n = collect_object_slots(tp, dummy, MAX_SLOTS, named_offs, named, 4);
    if (PyErr_Occurred())
        PyErr_Clear();
    L->ok = (n > 0 && L->subscriptions_off >= 0 && L->shared_off >= 0 &&
             L->shared_selected_off >= 0 && L->inline_off >= 0);
    n_res_layouts++;
    return L;
}

/* ---------------------------------------------------------------------- */

#define SLOT_AT(obj, off) (*(PyObject **)((char *)(obj) + (off)))

/* Port: which path built each result and each first-sighting copy,
 * exported via view_stats() (a test observes that the port's Subscribers
 * and Subscription take the slot paths) */
static long long stat_slot_results, stat_generic_results;
static long long stat_slot_copies, stat_method_copies;

/* Subscription.self_merged_copy through the slot layout; falls back to
 * the Python method for unknown layouts. New reference or NULL. */
static PyObject *
client_first_sighting(PyObject *sub)
{
    SubLayout *L = sub_layout_for(Py_TYPE(sub));
    if (L == NULL || !L->ok) {
        stat_method_copies++;
        return PyObject_CallMethodNoArgs(sub, s_self_merged_copy);
    }
    PyTypeObject *tp = Py_TYPE(sub);
    PyObject *fresh = tp->tp_alloc(tp, 0);
    if (fresh == NULL)
        return NULL;
    stat_slot_copies++;
    for (int i = 0; i < L->n; i++) {
        PyObject *v = SLOT_AT(sub, L->offs[i]);
        Py_XINCREF(v);
        SLOT_AT(fresh, L->offs[i]) = v;
    }
    /* Result copies reference only strings/ints/bools plus the shared
     * identifiers dict and share_name list (themselves still tracked):
     * they cannot participate in reference cycles, so untracking them
     * keeps tens of thousands of per-batch copies out of every young-gen
     * GC scan — measurably half the materialization cost at full batch
     * sizes (subtype_dealloc handles an already-untracked object fine). */
    PyObject_GC_UnTrack(fresh);
    PyObject *ids = SLOT_AT(fresh, L->ids_off);
    PyObject *filter = SLOT_AT(fresh, L->filter_off);
    PyObject *ident = SLOT_AT(fresh, L->ident_off);
    if (filter != NULL && ident != NULL) {
        if (ids == NULL || ids == Py_None) {
            PyObject *d = PyDict_New();
            if (d == NULL || PyDict_SetItem(d, filter, ident) < 0) {
                Py_XDECREF(d);
                Py_DECREF(fresh);
                return NULL;
            }
            SLOT_AT(fresh, L->ids_off) = d; /* owns the new dict */
            Py_XDECREF(ids);
        }
        else {
            long idv = PyLong_AsLong(ident);
            if (idv == -1 && PyErr_Occurred()) {
                Py_DECREF(fresh);
                return NULL;
            }
            if (idv > 0 && PyDict_SetItem(ids, filter, ident) < 0) {
                Py_DECREF(fresh);
                return NULL;
            }
        }
    }
    return fresh;
}

/* ---------------------------------------------------------------------- */
/* Port: the tenant namespace guards (topics.ns_guard_class/_mode)        */
/*                                                                        */
/* A topic scoped into a tenant namespace starts with NS_CHAR (U+0000);   */
/* the caller passes its ns_guard_mode (0 outside every namespace, 2 for  */
/* a tenant-local '$' first level, else 1). An entry whose filter has     */
/* guard class g (1: a global '+'/'#' first level; 2: a scoped filter     */
/* whose tenant-local first level is '+'/'#' or empty) is dropped when    */
/* 0 < g <= mode. A shared entry's class is that of its inner filter      */
/* (after "$SHARE/<group>/"). The class is read from the entry's own      */
/* filter, per sid, so it holds for any trie layout; mode 0 (every        */
/* unscoped topic) costs nothing.                                         */

#define NS_CHAR 0

/* topics.ns_guard_class of f[from:] ("" is class 0). A scoped key's
 * tenant-local first character is the one after its first '/', or ""
 * when there is none — and "" counts as '+'/'#' there, as the Python
 * ``"" in "+#"`` does. Returns -1 with an exception set on error. */
static int
guard_class_from(PyObject *f, Py_ssize_t from)
{
    Py_ssize_t n = PyUnicode_GET_LENGTH(f);
    if (from >= n)
        return 0;
    Py_UCS4 c0 = PyUnicode_READ_CHAR(f, from);
    if (c0 == '+' || c0 == '#')
        return 1;
    if (c0 != NS_CHAR)
        return 0;
    Py_ssize_t i = PyUnicode_FindChar(f, '/', from, n, 1);
    if (i == -2)
        return -1;
    if (i < 0 || i + 1 >= n)
        return 2;
    Py_UCS4 c = PyUnicode_READ_CHAR(f, i + 1);
    return (c == '+' || c == '#') ? 2 : 0;
}

/* The guard class of one stored subscription: its filter's, or for a
 * shared entry its inner filter's (topics.shared_inner: the text after
 * the second '/', "" when there is none). -1 on error. */
static int
sub_guard_class(PyObject *sub, int shared)
{
    SubLayout *L = sub_layout_for(Py_TYPE(sub));
    PyObject *f;
    int owned = 0;
    if (L != NULL && L->ok && (f = SLOT_AT(sub, L->filter_off)) != NULL)
        ; /* borrowed from the instance slot */
    else {
        f = PyObject_GetAttr(sub, s_filter);
        if (f == NULL)
            return -1;
        owned = 1;
    }
    int g = 0;
    if (!PyUnicode_Check(f)) {
        PyErr_SetString(PyExc_TypeError, "subscription filter must be a str");
        g = -1;
    }
    else if (!shared)
        g = guard_class_from(f, 0);
    else {
        Py_ssize_t n = PyUnicode_GET_LENGTH(f);
        Py_ssize_t i1 = PyUnicode_FindChar(f, '/', 0, n, 1);
        Py_ssize_t i2 = i1 >= 0 ? PyUnicode_FindChar(f, '/', i1 + 1, n, 1) : -1;
        if (i1 == -2 || i2 == -2)
            g = -1;
        else
            g = i2 >= 0 ? guard_class_from(f, i2 + 1) : 0;
    }
    if (owned)
        Py_DECREF(f);
    return g;
}

/* 1 when the guard drops ``sid`` for a topic of guard mode ``mode``, 0
 * when it keeps it (out-of-range sids are kept here: every caller skips
 * them), -1 on error. */
static int
sid_guarded(int64_t sid, PyObject *snaps, Py_ssize_t n_snaps,
            int64_t window, int mode)
{
    if (mode <= 0)
        return 0;
    int64_t ordinal = sid / window;
    int64_t local = sid % window;
    if (sid < 0 || ordinal >= n_snaps)
        return 0;
    PyObject *snap = PyList_GET_ITEM(snaps, ordinal);
    if (!PyTuple_Check(snap) || PyTuple_GET_SIZE(snap) != 3) {
        PyErr_SetString(PyExc_TypeError, "snapshot entries must be 3-tuples");
        return -1;
    }
    PyObject *cli = PyTuple_GET_ITEM(snap, 0);
    PyObject *shr = PyTuple_GET_ITEM(snap, 1);
    PyObject *inl = PyTuple_GET_ITEM(snap, 2);
    Py_ssize_t n_cli = PyTuple_GET_SIZE(cli);
    Py_ssize_t n_shr = PyTuple_GET_SIZE(shr);
    PyObject *sub;
    int shared = 0;
    if (local < n_cli)
        sub = PyTuple_GET_ITEM(PyTuple_GET_ITEM(cli, local), 1);
    else if (local < n_cli + n_shr) {
        sub = PyTuple_GET_ITEM(PyTuple_GET_ITEM(shr, local - n_cli), 1);
        shared = 1;
    }
    else if (local < n_cli + n_shr + PyTuple_GET_SIZE(inl))
        sub = PyTuple_GET_ITEM(inl, local - n_cli - n_shr);
    else
        return 0;
    int g = sub_guard_class(sub, shared);
    if (g < 0)
        return -1;
    return g > 0 && g <= mode;
}

/* The guard mode of topic ``i`` from the caller's per-topic int8 buffer
 * (NULL: no topic of the batch is scoped). */
#define MODE_AT(modes, i) ((modes) != NULL ? (int)(modes)[i] : 0)

/* Borrow the per-topic modes buffer (None: no scoped topic). Returns 0
 * ok, -1 error; on success ``*out`` is NULL or the int8 data, and the
 * caller releases ``view`` when ``view->buf`` is set. */
static int
get_modes(PyObject *modes_obj, Py_buffer *view, Py_ssize_t n_topics,
          const int8_t **out)
{
    view->buf = NULL;
    *out = NULL;
    if (modes_obj == NULL || modes_obj == Py_None)
        return 0;
    if (PyObject_GetBuffer(modes_obj, view, PyBUF_C_CONTIGUOUS) < 0) {
        view->buf = NULL;
        return -1;
    }
    if (view->itemsize != 1 || view->len < n_topics) {
        PyBuffer_Release(view);
        view->buf = NULL;
        PyErr_SetString(PyExc_ValueError,
                        "modes must be an int8 buffer of one per topic");
        return -1;
    }
    *out = (const int8_t *)view->buf;
    return 0;
}

/* Merge one sid into the result dicts. Returns 0 on success, -1 on
 * error. Skips (returns 0) on out-of-range sids — host-parity with
 * expand_sids' bounds check — and (Port) on sids the namespace guard
 * drops for a topic of guard mode ``mode``. */
static int
merge_sid(int64_t sid, PyObject *snaps, Py_ssize_t n_snaps, int64_t window,
          int mode, PyObject *subscriptions, PyObject *shared,
          PyObject *inline_subs)
{
    int64_t ordinal = sid / window;
    int64_t local = sid % window;
    if (sid < 0 || ordinal >= n_snaps)
        return 0;
    if (mode > 0) {
        int g = sid_guarded(sid, snaps, n_snaps, window, mode);
        if (g != 0)
            return g < 0 ? -1 : 0;
    }

    PyObject *snap = PyList_GET_ITEM(snaps, ordinal); /* borrowed */
    if (!PyTuple_Check(snap) || PyTuple_GET_SIZE(snap) != 3) {
        PyErr_SetString(PyExc_TypeError, "snapshot entries must be 3-tuples");
        return -1;
    }
    PyObject *cli = PyTuple_GET_ITEM(snap, 0);
    PyObject *shr = PyTuple_GET_ITEM(snap, 1);
    PyObject *inl = PyTuple_GET_ITEM(snap, 2);
    Py_ssize_t n_cli = PyTuple_GET_SIZE(cli);
    Py_ssize_t n_shr = PyTuple_GET_SIZE(shr);
    Py_ssize_t n_inl = PyTuple_GET_SIZE(inl);

    if (local < n_cli) {
        /* client subscription: first sighting copies, repeats merge */
        PyObject *pair = PyTuple_GET_ITEM(cli, local);
        PyObject *client = PyTuple_GET_ITEM(pair, 0);
        PyObject *sub = PyTuple_GET_ITEM(pair, 1);
        PyObject *prev = PyDict_GetItemWithError(subscriptions, client);
        if (prev == NULL) {
            if (PyErr_Occurred())
                return -1;
            PyObject *fresh = client_first_sighting(sub);
            if (fresh == NULL)
                return -1;
            int r = PyDict_SetItem(subscriptions, client, fresh);
            Py_DECREF(fresh);
            return r;
        }
        PyObject *merged =
            PyObject_CallMethodObjArgs(prev, s_merge, sub, NULL);
        if (merged == NULL)
            return -1;
        int r = PyDict_SetItem(subscriptions, client, merged);
        Py_DECREF(merged);
        return r;
    }
    if (local < n_cli + n_shr) {
        /* shared: group dict keyed on the full $SHARE filter; the stored
         * subscription is referenced, not copied */
        PyObject *pair = PyTuple_GET_ITEM(shr, local - n_cli);
        PyObject *client = PyTuple_GET_ITEM(pair, 0);
        PyObject *sub = PyTuple_GET_ITEM(pair, 1);
        SubLayout *L = sub_layout_for(Py_TYPE(sub));
        PyObject *gf;
        int gf_owned = 0;
        if (L != NULL && L->ok && (gf = SLOT_AT(sub, L->filter_off)) != NULL)
            ; /* borrowed from the instance slot */
        else {
            gf = PyObject_GetAttr(sub, s_filter);
            if (gf == NULL)
                return -1;
            gf_owned = 1;
        }
        PyObject *group = PyDict_GetItemWithError(shared, gf);
        if (group == NULL) {
            if (PyErr_Occurred()) {
                if (gf_owned)
                    Py_DECREF(gf);
                return -1;
            }
            group = PyDict_New();
            if (group == NULL || PyDict_SetItem(shared, gf, group) < 0) {
                Py_XDECREF(group);
                if (gf_owned)
                    Py_DECREF(gf);
                return -1;
            }
            Py_DECREF(group); /* borrowed from `shared` hereafter */
        }
        if (gf_owned)
            Py_DECREF(gf);
        return PyDict_SetItem(group, client, sub);
    }
    if (local < n_cli + n_shr + n_inl) {
        /* inline: keyed on the subscription identifier */
        PyObject *sub = PyTuple_GET_ITEM(inl, local - n_cli - n_shr);
        SubLayout *L = sub_layout_for(Py_TYPE(sub));
        PyObject *ident;
        int owned = 0;
        if (L != NULL && L->ok &&
            (ident = SLOT_AT(sub, L->ident_off)) != NULL)
            ;
        else {
            ident = PyObject_GetAttr(sub, s_identifier);
            if (ident == NULL)
                return -1;
            owned = 1;
        }
        int r = PyDict_SetItem(inline_subs, ident, sub);
        if (owned)
            Py_DECREF(ident);
        return r;
    }
    return 0; /* slot beyond the snapshot: skip (parity with bounds check) */
}

/* A fresh Subscribers result: tp_alloc + four empty dicts when the class
 * has the expected slots layout, the plain constructor otherwise. The
 * three gather dicts are returned as NEW (owned) references — a
 * Subscribers-compatible class whose accessors are properties returning
 * fresh objects must not leave the caller holding dangling pointers, so
 * the caller keeps the containers alive for the whole merge loop and
 * Py_DECREFs all three when done. */
static PyObject *
new_result(PyObject *cls, ResLayout *L, PyObject **subscriptions,
           PyObject **shared, PyObject **inline_subs)
{
    if (L != NULL && L->ok) {
        PyTypeObject *tp = (PyTypeObject *)cls;
        PyObject *o = tp->tp_alloc(tp, 0);
        if (o == NULL)
            return NULL;
        PyObject *a = PyDict_New(), *b = PyDict_New(), *c = PyDict_New(),
                 *d = PyDict_New();
        if (a == NULL || b == NULL || c == NULL || d == NULL) {
            Py_XDECREF(a);
            Py_XDECREF(b);
            Py_XDECREF(c);
            Py_XDECREF(d);
            Py_DECREF(o);
            return NULL;
        }
        SLOT_AT(o, L->shared_off) = a;
        SLOT_AT(o, L->shared_selected_off) = b;
        SLOT_AT(o, L->subscriptions_off) = c;
        SLOT_AT(o, L->inline_off) = d;
        stat_slot_results++;
        /* same cycle argument as the subscription copies: the result
         * object only points at its four dicts (which stay tracked) */
        PyObject_GC_UnTrack(o);
        Py_INCREF(c);
        Py_INCREF(a);
        Py_INCREF(d);
        *subscriptions = c;
        *shared = a;
        *inline_subs = d;
        return o;
    }
    PyObject *o = PyObject_CallNoArgs(cls);
    if (o == NULL)
        return NULL;
    stat_generic_results++;
    /* attribute access may run arbitrary descriptors: keep the fetched
     * references OWNED for the merge loop's duration (the caller
     * releases them) instead of assuming the object stores and retains
     * these exact containers */
    PyObject *c = PyObject_GetAttr(o, s_subscriptions);
    PyObject *a = PyObject_GetAttr(o, s_shared);
    PyObject *d = PyObject_GetAttr(o, s_inline_subscriptions);
    if (c == NULL || a == NULL || d == NULL) {
        Py_XDECREF(c);
        Py_XDECREF(a);
        Py_XDECREF(d);
        Py_DECREF(o);
        return NULL;
    }
    *subscriptions = c;
    *shared = a;
    *inline_subs = d;
    return o;
}

/* resolve_batch(packed, n_topics, P, snaps, window, subscribers_cls,
 *               modes=None)
 *   packed:   C-contiguous int32 buffer, rows of 2P+2 ints
 *             (P starts | P counts | total | overflow)
 *   snaps:    list of (clients, shared, inline) tuples (sid // window)
 *   modes:    (Port) None, or an int8 buffer of each topic's
 *             ns_guard_mode (the namespace guard)
 *   returns:  (results, overflow_indices) — results[i] is a Subscribers
 *             instance, or None where the row's overflow flag was set
 *             (the caller re-walks those topics on the host trie). */
static PyObject *
resolve_batch(PyObject *Py_UNUSED(self), PyObject *args)
{
    PyObject *packed_obj, *snaps, *subscribers_cls, *modes_obj = Py_None;
    Py_ssize_t n_topics, P;
    long long window;
    if (!PyArg_ParseTuple(args, "OnnOLO|O", &packed_obj, &n_topics, &P,
                          &snaps, &window, &subscribers_cls, &modes_obj))
        return NULL;
    if (!PyList_Check(snaps)) {
        PyErr_SetString(PyExc_TypeError, "snaps must be a list");
        return NULL;
    }
    if (window <= 0 || P < 0 || !PyType_Check(subscribers_cls)) {
        PyErr_SetString(PyExc_ValueError,
                        "window must be > 0, P >= 0, cls a type");
        return NULL;
    }

    Py_buffer view, modes_v;
    const int8_t *modes;
    if (get_modes(modes_obj, &modes_v, n_topics, &modes) < 0)
        return NULL;
    if (PyObject_GetBuffer(packed_obj, &view, PyBUF_C_CONTIGUOUS) < 0) {
        if (modes_v.buf != NULL)
            PyBuffer_Release(&modes_v);
        return NULL;
    }
    Py_ssize_t row_ints = 2 * P + 2;
    if (view.itemsize != 4 ||
        view.len < n_topics * row_ints * (Py_ssize_t)sizeof(int32_t)) {
        PyBuffer_Release(&view);
        if (modes_v.buf != NULL)
            PyBuffer_Release(&modes_v);
        PyErr_SetString(PyExc_ValueError,
                        "packed buffer must be int32 [n_topics, 2P+2]");
        return NULL;
    }
    const int32_t *data = (const int32_t *)view.buf;
    Py_ssize_t n_snaps = PyList_GET_SIZE(snaps);
    ResLayout *RL = res_layout_for((PyTypeObject *)subscribers_cls);

    PyObject *results = PyList_New(n_topics);
    PyObject *overflow_idx = PyList_New(0);
    if (results == NULL || overflow_idx == NULL)
        goto fail;

    for (Py_ssize_t i = 0; i < n_topics; i++) {
        const int32_t *row = data + i * row_ints;
        if (row[2 * P + 1]) { /* overflow: host re-walk decides */
            PyObject *idx = PyLong_FromSsize_t(i);
            if (idx == NULL || PyList_Append(overflow_idx, idx) < 0) {
                Py_XDECREF(idx);
                goto fail;
            }
            Py_DECREF(idx);
            Py_INCREF(Py_None);
            PyList_SET_ITEM(results, i, Py_None);
            continue;
        }
        PyObject *subscriptions, *shared, *inline_subs;
        PyObject *subs_obj = new_result(subscribers_cls, RL, &subscriptions,
                                        &shared, &inline_subs);
        if (subs_obj == NULL)
            goto fail;
        PyList_SET_ITEM(results, i, subs_obj); /* steals */
        int merr = 0;
        int mode = MODE_AT(modes, i);
        for (Py_ssize_t p = 0; p < P && !merr; p++) {
            int32_t cnt = row[P + p];
            if (cnt <= 0)
                continue;
            int64_t start = row[p];
            for (int32_t k = 0; k < cnt; k++) {
                if (merge_sid(start + k, snaps, n_snaps, window, mode,
                              subscriptions, shared, inline_subs) < 0) {
                    merr = 1;
                    break;
                }
            }
        }
        /* new_result hands the gather containers as owned refs held for
         * the merge loop's duration (property-backed results may have
         * returned containers the object does not itself retain) */
        Py_DECREF(subscriptions);
        Py_DECREF(shared);
        Py_DECREF(inline_subs);
        if (merr)
            goto fail;
    }

    PyBuffer_Release(&view);
    if (modes_v.buf != NULL)
        PyBuffer_Release(&modes_v);
    PyObject *out = PyTuple_Pack(2, results, overflow_idx);
    Py_DECREF(results);
    Py_DECREF(overflow_idx);
    return out;

fail:
    PyBuffer_Release(&view);
    if (modes_v.buf != NULL)
        PyBuffer_Release(&modes_v);
    Py_XDECREF(results);
    Py_XDECREF(overflow_idx);
    return NULL;
}

/* resolve_compact(sids, shards, totals, route, n_hits, n_topics, snaps,
 *                 window, subscribers_cls, modes=None)
 *   sids:    C-contiguous int32 buffer — the device-compacted pair
 *            stream (topic-major; the per-topic totals drive the cursor,
 *            so each pair's topic_idx is implicit)
 *   shards:  None (single-device: sid space is snaps) or a parallel
 *            int32 buffer of per-pair shard ids — snaps is then a list
 *            of per-shard snapshot lists (mesh-sharded form)
 *   totals:  int32 buffer [B] — hits per (padded) batch row
 *   route:   int32 buffer [B] — nonzero = host re-walk (device overflow,
 *            over-deep topic, delta-routed): results[i] stays None and i
 *            lands in overflow_indices; the row's pairs are skipped
 *   modes:   (Port) None or the per-topic ns_guard_mode, as resolve_batch
 *   returns: (results, overflow_indices) like resolve_batch.
 * The cursor must land exactly on n_hits after the walk — a mismatch
 * means the caller mixed buffers from different batches and is an error,
 * never a silent mis-expansion. */
static PyObject *
resolve_compact(PyObject *Py_UNUSED(self), PyObject *args)
{
    PyObject *sids_obj, *shards_obj, *totals_obj, *route_obj, *snaps,
        *subscribers_cls, *modes_obj = Py_None;
    Py_ssize_t n_hits, n_topics;
    long long window;
    if (!PyArg_ParseTuple(args, "OOOOnnOLO|O", &sids_obj, &shards_obj,
                          &totals_obj, &route_obj, &n_hits, &n_topics,
                          &snaps, &window, &subscribers_cls, &modes_obj))
        return NULL;
    int sharded = shards_obj != Py_None;
    if (!PyList_Check(snaps)) {
        PyErr_SetString(PyExc_TypeError, "snaps must be a list");
        return NULL;
    }
    if (window <= 0 || n_hits < 0 || n_topics < 0 ||
        !PyType_Check(subscribers_cls)) {
        PyErr_SetString(PyExc_ValueError,
                        "window must be > 0, counts >= 0, cls a type");
        return NULL;
    }

    Py_buffer sids_v, totals_v, route_v, shards_v, modes_v;
    sids_v.buf = totals_v.buf = route_v.buf = shards_v.buf = NULL;
    const int8_t *modes;
    PyObject *results = NULL, *overflow_idx = NULL, *out = NULL;
    if (get_modes(modes_obj, &modes_v, n_topics, &modes) < 0)
        return NULL;
    if (PyObject_GetBuffer(sids_obj, &sids_v, PyBUF_C_CONTIGUOUS) < 0) {
        if (modes_v.buf != NULL)
            PyBuffer_Release(&modes_v);
        return NULL;
    }
    if (PyObject_GetBuffer(totals_obj, &totals_v, PyBUF_C_CONTIGUOUS) < 0)
        goto done;
    if (PyObject_GetBuffer(route_obj, &route_v, PyBUF_C_CONTIGUOUS) < 0)
        goto done;
    if (sharded &&
        PyObject_GetBuffer(shards_obj, &shards_v, PyBUF_C_CONTIGUOUS) < 0)
        goto done;
    if (sids_v.itemsize != 4 || totals_v.itemsize != 4 ||
        route_v.itemsize != 4 || (sharded && shards_v.itemsize != 4)) {
        PyErr_SetString(PyExc_ValueError, "buffers must be int32");
        goto done;
    }
    Py_ssize_t B = totals_v.len / 4;
    Py_ssize_t n_sids = sids_v.len / 4;
    if (route_v.len / 4 < B || n_topics > B || n_hits > n_sids ||
        (sharded && shards_v.len / 4 < n_sids)) {
        PyErr_SetString(PyExc_ValueError,
                        "compact buffers disagree on batch geometry");
        goto done;
    }
    const int32_t *sids = (const int32_t *)sids_v.buf;
    const int32_t *totals = (const int32_t *)totals_v.buf;
    const int32_t *route = (const int32_t *)route_v.buf;
    const int32_t *shards = sharded ? (const int32_t *)shards_v.buf : NULL;
    Py_ssize_t n_shards = sharded ? PyList_GET_SIZE(snaps) : 0;

    results = PyList_New(n_topics);
    overflow_idx = PyList_New(0);
    if (results == NULL || overflow_idx == NULL)
        goto done;

    /* loop-invariant: one layout lookup per call (resolve_batch parity) */
    ResLayout *RL = res_layout_for((PyTypeObject *)subscribers_cls);
    Py_ssize_t cursor = 0;
    for (Py_ssize_t i = 0; i < B; i++) {
        int32_t t = totals[i];
        if (t < 0 || cursor + t > n_hits) {
            PyErr_SetString(PyExc_ValueError,
                            "compact totals overrun the pair stream");
            goto done;
        }
        if (i >= n_topics || route[i]) {
            if (i < n_topics) {
                PyObject *idx = PyLong_FromSsize_t(i);
                if (idx == NULL || PyList_Append(overflow_idx, idx) < 0) {
                    Py_XDECREF(idx);
                    goto done;
                }
                Py_DECREF(idx);
                Py_INCREF(Py_None);
                PyList_SET_ITEM(results, i, Py_None);
            }
            cursor += t; /* skip the routed/padded row's pairs */
            continue;
        }
        PyObject *subscriptions, *shared, *inline_subs;
        PyObject *subs_obj = new_result(subscribers_cls, RL, &subscriptions,
                                        &shared, &inline_subs);
        if (subs_obj == NULL)
            goto done;
        PyList_SET_ITEM(results, i, subs_obj); /* steals */
        int merr = 0;
        for (int32_t k = 0; k < t && !merr; k++) {
            Py_ssize_t j = cursor + k;
            PyObject *shard_snaps = snaps;
            if (sharded) {
                int32_t s = shards[j];
                if (s < 0 || s >= n_shards) {
                    PyErr_SetString(PyExc_ValueError,
                                    "pair shard id out of range");
                    merr = 1;
                    break;
                }
                shard_snaps = PyList_GET_ITEM(snaps, s); /* borrowed */
                if (!PyList_Check(shard_snaps)) {
                    PyErr_SetString(PyExc_TypeError,
                                    "sharded snaps must be a list of lists");
                    merr = 1;
                    break;
                }
            }
            if (merge_sid(sids[j], shard_snaps, PyList_GET_SIZE(shard_snaps),
                          window, MODE_AT(modes, i), subscriptions, shared,
                          inline_subs) < 0)
                merr = 1;
        }
        Py_DECREF(subscriptions);
        Py_DECREF(shared);
        Py_DECREF(inline_subs);
        if (merr)
            goto done;
        cursor += t;
    }
    if (cursor != n_hits) {
        PyErr_SetString(PyExc_ValueError,
                        "compact pair stream and totals disagree");
        goto done;
    }
    out = PyTuple_Pack(2, results, overflow_idx);

done:
    PyBuffer_Release(&sids_v);
    if (modes_v.buf != NULL)
        PyBuffer_Release(&modes_v);
    if (totals_v.buf != NULL)
        PyBuffer_Release(&totals_v);
    if (route_v.buf != NULL)
        PyBuffer_Release(&route_v);
    if (sharded && shards_v.buf != NULL)
        PyBuffer_Release(&shards_v);
    Py_XDECREF(results);
    Py_XDECREF(overflow_idx);
    return out;
}

/* expand_sids_list(sids, snaps, window, subscribers_obj, mode=0) — the
 * same merge
 * over an explicit sid list into an EXISTING Subscribers instance; used by
 * the differential tests and any caller holding slot arrays rather than
 * ranges. Duplicate sids merge twice exactly like expand_sids would
 * without its seen-set — callers pass de-duplicated lists (ranges are
 * disjoint by construction). ``mode`` (Port) is the topic's
 * ns_guard_mode. */
static PyObject *
expand_sids_list(PyObject *Py_UNUSED(self), PyObject *args)
{
    PyObject *sids, *snaps, *subs_obj;
    long long window;
    int mode = 0;
    if (!PyArg_ParseTuple(args, "OOLO|i", &sids, &snaps, &window, &subs_obj,
                          &mode))
        return NULL;
    if (!PyList_Check(sids) || !PyList_Check(snaps)) {
        PyErr_SetString(PyExc_TypeError, "sids and snaps must be lists");
        return NULL;
    }
    if (window <= 0) {
        PyErr_SetString(PyExc_ValueError, "window must be > 0");
        return NULL;
    }
    PyObject *subscriptions = PyObject_GetAttr(subs_obj, s_subscriptions);
    PyObject *shared = PyObject_GetAttr(subs_obj, s_shared);
    PyObject *inline_subs =
        PyObject_GetAttr(subs_obj, s_inline_subscriptions);
    if (subscriptions == NULL || shared == NULL || inline_subs == NULL) {
        Py_XDECREF(subscriptions);
        Py_XDECREF(shared);
        Py_XDECREF(inline_subs);
        return NULL;
    }
    Py_ssize_t n_snaps = PyList_GET_SIZE(snaps);
    Py_ssize_t n = PyList_GET_SIZE(sids);
    int err = 0;
    for (Py_ssize_t i = 0; i < n && !err; i++) {
        PyObject *sid_obj = PyList_GET_ITEM(sids, i);
        long long sid = PyLong_AsLongLong(sid_obj);
        if (sid == -1 && PyErr_Occurred()) {
            err = 1;
            break;
        }
        if (merge_sid(sid, snaps, n_snaps, window, mode, subscriptions,
                      shared, inline_subs) < 0)
            err = 1;
    }
    Py_DECREF(subscriptions);
    Py_DECREF(shared);
    Py_DECREF(inline_subs);
    if (err)
        return NULL;
    Py_INCREF(subs_obj);
    return subs_obj;
}

/* expand_snap(snap, subscribers_cls, mode=0) — materialize ONE node snapshot
 * tuple into a fresh Subscribers result: the single-node case of the
 * host gather, used by the exact-map fast path (wildcard-free filter
 * sets — ops/matcher.TpuMatcher._expand_snap is the Python oracle).
 * Each client appears at most once per node, so every client entry is
 * the first-sighting copy; shared entries are referenced keyed on the
 * group filter; inline entries key on identifier. ``mode`` (Port) is the
 * topic's ns_guard_mode. */
static PyObject *
expand_snap(PyObject *Py_UNUSED(self), PyObject *args)
{
    PyObject *snap, *subscribers_cls;
    int mode = 0;
    if (!PyArg_ParseTuple(args, "OO|i", &snap, &subscribers_cls, &mode))
        return NULL;
    if (!PyTuple_Check(snap) || PyTuple_GET_SIZE(snap) != 3) {
        PyErr_SetString(PyExc_TypeError, "snap must be a 3-tuple");
        return NULL;
    }
    if (!PyType_Check(subscribers_cls)) {
        PyErr_SetString(PyExc_TypeError, "subscribers_cls must be a type");
        return NULL;
    }
    ResLayout *RL = res_layout_for((PyTypeObject *)subscribers_cls);
    PyObject *subscriptions, *shared, *inline_subs;
    PyObject *subs_obj = new_result(subscribers_cls, RL, &subscriptions,
                                    &shared, &inline_subs);
    if (subs_obj == NULL)
        return NULL;

    PyObject *cli = PyTuple_GET_ITEM(snap, 0);
    PyObject *shr = PyTuple_GET_ITEM(snap, 1);
    PyObject *inl = PyTuple_GET_ITEM(snap, 2);
    if (!PyTuple_Check(cli) || !PyTuple_Check(shr) || !PyTuple_Check(inl)) {
        PyErr_SetString(PyExc_TypeError,
                        "snap sections must be tuples (clients, shared, inline)");
        goto fail;
    }
    Py_ssize_t n_cli = PyTuple_GET_SIZE(cli);
    Py_ssize_t n_shr = PyTuple_GET_SIZE(shr);
    Py_ssize_t n_inl = PyTuple_GET_SIZE(inl);
    /* the snapshot layout guarantees sid slot ordering: clients, then
     * shared members, then inline — merge_sid resolves the same tuple by
     * index, so one single-entry wrapper covers all three sections */
    PyObject *snaps = PyList_New(1);
    if (snaps == NULL)
        goto fail;
    Py_INCREF(snap);
    PyList_SET_ITEM(snaps, 0, snap); /* steals the new ref */
    Py_ssize_t total = n_cli + n_shr + n_inl;
    for (Py_ssize_t k = 0; k < total; k++) {
        if (merge_sid(k, snaps, 1, total + 1, mode, subscriptions, shared,
                      inline_subs) < 0) {
            Py_DECREF(snaps);
            goto fail;
        }
    }
    Py_DECREF(snaps);
    Py_DECREF(subscriptions);
    Py_DECREF(shared);
    Py_DECREF(inline_subs);
    return subs_obj;

fail:
    /* the owned gather-container refs from new_result */
    Py_DECREF(subscriptions);
    Py_DECREF(shared);
    Py_DECREF(inline_subs);
    Py_DECREF(subs_obj);
    return NULL;
}

/* ====================================================================== */
/* Lazy fan-out views: zero-materialization Subscribers                   */
/*                                                                        */
/* The eager resolvers above expand every (topic_idx, sid) pair into      */
/* Python dict-of-Subscription results whether or not anything reads      */
/* them. At 1M wildcard subscriptions that tp_alloc + dict-store loop IS  */
/* the end-to-end bound. The view types here                              */
/* keep the device pair stream (or the packed ranges row) as the result   */
/* CURRENCY: a SubscribersView holds a zero-copy slice of the device      */
/* buffer plus the sid->snapshot table and yields fan-out targets on      */
/* demand. Nothing is materialized until a consumer actually asks for     */
/* dict semantics, at which point materialize() runs the exact eager      */
/* merge loop (bit-identical by construction — the eager path stays the   */
/* differential oracle, pinned by tests/test_torch_native.py).            */
/*                                                                        */
/* Lifetime rules (the owned-refs discipline extended to views):          */
/*  - a _PairBatch owns the device buffer exports and the snapshot list   */
/*    for as long as ANY view over it is alive — snapshots pin client-id  */
/*    strings and Subscription objects, so an unsubscribe/disconnect      */
/*    between resolve and consumption can never UAF (delivery to dead     */
/*    clients is gated by the live registry at fan-out, not here);        */
/*  - per-hit Subscription copies come from a bounded freelist pool and   */
/*    are RECYCLED only when the view can prove sole ownership            */
/*    (refcount checks at view dealloc), never by timer or guess.         */
/* ====================================================================== */

#define VIEW_MODE_PAIRS 0
#define VIEW_MODE_RANGES 1

#define VIEW_HAS_CLIENT 1
#define VIEW_HAS_SHARED 2
#define VIEW_HAS_INLINE 4

/* module-lifetime view/pool accounting, exported via view_stats() */
static long long stat_views_created;
static long long stat_view_materializations;
static long long stat_pool_hits;
static long long stat_pool_returns;

/* ---- Subscription freelist pool -------------------------------------- */
/* Pooled instances are exact-type objects with a usable slot layout       */
/* whose slots are all cleared while parked. The pool owns one reference   */
/* per parked object; pool_get transfers it to the caller. Only view      */
/* paths allocate from (and return to) the pool — the eager oracle keeps  */
/* plain tp_alloc so the two paths stay independently verifiable.         */

#define SUB_POOL_MAX 2048
static PyObject *sub_pool[SUB_POOL_MAX];
static int sub_pool_n;
static PyTypeObject *sub_pool_tp; /* the one pooled type (first L->ok seen) */

static PyObject *
pool_get(PyTypeObject *tp)
{
    if (tp == sub_pool_tp && sub_pool_n > 0) {
        stat_pool_hits++;
        return sub_pool[--sub_pool_n]; /* refcount 1, slots all NULL */
    }
    return NULL;
}

/* Park one copy we solely own (refcount already ours to give). Clears
 * every object slot; falls back to a plain DECREF when the pool is full
 * or the type is not the pooled one. */
static void
pool_put(PyObject *obj)
{
    PyTypeObject *tp = Py_TYPE(obj);
    SubLayout *L;
    if (tp != sub_pool_tp || sub_pool_n >= SUB_POOL_MAX ||
        (L = sub_layout_for(tp)) == NULL || !L->ok) {
        Py_DECREF(obj);
        return;
    }
    for (int i = 0; i < L->n; i++) {
        PyObject *v = SLOT_AT(obj, L->offs[i]);
        SLOT_AT(obj, L->offs[i]) = NULL;
        Py_XDECREF(v);
    }
    sub_pool[sub_pool_n++] = obj;
    stat_pool_returns++;
}

/* client_first_sighting through the pool: identical semantics, but the
 * fresh instance comes from the freelist when one is parked and its
 * handout is tracked on ``pooled`` (a PyList) so the owning view can
 * recycle it once nothing else references it. */
static PyObject *
first_sighting_pooled(PyObject *sub, PyObject *pooled)
{
    SubLayout *L = sub_layout_for(Py_TYPE(sub));
    if (L == NULL || !L->ok || pooled == NULL)
        return client_first_sighting(sub);
    PyTypeObject *tp = Py_TYPE(sub);
    if (sub_pool_tp == NULL)
        sub_pool_tp = tp; /* adopt the first poolable type (the real
                           * packets.Subscription in production) */
    PyObject *fresh = pool_get(tp);
    if (fresh == NULL) {
        /* pool empty: plain copy, but still TRACKED — parking it at view
         * dealloc is how the pool fills in the first place */
        fresh = client_first_sighting(sub);
        if (fresh == NULL)
            return NULL;
        if (PyList_Append(pooled, fresh) < 0) {
            Py_DECREF(fresh);
            return NULL;
        }
        return fresh;
    }
    stat_slot_copies++;
    for (int i = 0; i < L->n; i++) {
        PyObject *v = SLOT_AT(sub, L->offs[i]);
        Py_XINCREF(v);
        SLOT_AT(fresh, L->offs[i]) = v;
    }
    /* identifiers materialization — the exact client_first_sighting
     * contract (shared-and-extended when identifier > 0) */
    PyObject *ids = SLOT_AT(fresh, L->ids_off);
    PyObject *filter = SLOT_AT(fresh, L->filter_off);
    PyObject *ident = SLOT_AT(fresh, L->ident_off);
    if (filter != NULL && ident != NULL) {
        if (ids == NULL || ids == Py_None) {
            PyObject *d = PyDict_New();
            if (d == NULL || PyDict_SetItem(d, filter, ident) < 0) {
                Py_XDECREF(d);
                Py_DECREF(fresh);
                return NULL;
            }
            SLOT_AT(fresh, L->ids_off) = d;
            Py_XDECREF(ids);
        }
        else {
            long idv = PyLong_AsLong(ident);
            if (idv == -1 && PyErr_Occurred()) {
                Py_DECREF(fresh);
                return NULL;
            }
            if (idv > 0 && PyDict_SetItem(ids, filter, ident) < 0) {
                Py_DECREF(fresh);
                return NULL;
            }
        }
    }
    if (PyList_Append(pooled, fresh) < 0) {
        Py_DECREF(fresh);
        return NULL;
    }
    return fresh;
}

/* ---- _PairBatch ------------------------------------------------------- */

typedef struct {
    PyObject_HEAD
    PyObject *owner;        /* the int32 result array (pairs or ranges) */
    Py_buffer buf;          /* its exported view (held until dealloc) */
    PyObject *shards_owner; /* parallel shard-id array or NULL */
    Py_buffer shards_buf;
    int sharded;
    PyObject *snaps;   /* snapshot list (list of lists when sharded) */
    PyObject *cls;     /* the Subscribers class results materialize as */
    long long window;
    Py_ssize_t P;      /* ranges mode: probes per row (else 0) */
    int mode;
} BatchObject;

static void
Batch_dealloc(BatchObject *self)
{
    if (self->buf.buf != NULL)
        PyBuffer_Release(&self->buf);
    if (self->sharded && self->shards_buf.buf != NULL)
        PyBuffer_Release(&self->shards_buf);
    Py_XDECREF(self->owner);
    Py_XDECREF(self->shards_owner);
    Py_XDECREF(self->snaps);
    Py_XDECREF(self->cls);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyTypeObject BatchType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "mqtt_torch_accel._PairBatch",
    .tp_basicsize = sizeof(BatchObject),
    .tp_dealloc = (destructor)Batch_dealloc,
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_doc = "Shared owner of one resolved device batch's buffers.",
};

static BatchObject *
batch_new(PyObject *owner, PyObject *shards_owner, PyObject *snaps,
          PyObject *cls, long long window, Py_ssize_t P, int mode)
{
    BatchObject *b = PyObject_New(BatchObject, &BatchType);
    if (b == NULL)
        return NULL;
    b->owner = NULL;
    b->buf.buf = NULL;
    b->shards_owner = NULL;
    b->shards_buf.buf = NULL;
    b->sharded = 0;
    b->snaps = NULL;
    b->cls = NULL;
    b->window = window;
    b->P = P;
    b->mode = mode;
    if (PyObject_GetBuffer(owner, &b->buf, PyBUF_C_CONTIGUOUS) < 0) {
        b->buf.buf = NULL;
        Py_DECREF(b);
        return NULL;
    }
    Py_INCREF(owner);
    b->owner = owner;
    if (shards_owner != NULL && shards_owner != Py_None) {
        if (PyObject_GetBuffer(shards_owner, &b->shards_buf,
                               PyBUF_C_CONTIGUOUS) < 0) {
            b->shards_buf.buf = NULL;
            Py_DECREF(b);
            return NULL;
        }
        Py_INCREF(shards_owner);
        b->shards_owner = shards_owner;
        b->sharded = 1;
    }
    if (b->buf.itemsize != 4 ||
        (b->sharded && b->shards_buf.itemsize != 4)) {
        PyErr_SetString(PyExc_ValueError, "batch buffers must be int32");
        Py_DECREF(b);
        return NULL;
    }
    Py_INCREF(snaps);
    b->snaps = snaps;
    Py_INCREF(cls);
    b->cls = cls;
    return b;
}

/* ---- SubscribersView -------------------------------------------------- */

typedef struct {
    PyObject_HEAD
    BatchObject *batch;     /* owned */
    Py_ssize_t start;       /* pairs: first pair index; ranges: row offset
                             * in ints into the packed buffer */
    Py_ssize_t count;       /* pairs: n pairs (ranges: unused) */
    PyObject *materialized; /* cached eager Subscribers or NULL */
    PyObject *pooled;       /* PyList of pool handouts or NULL */
    int flags;              /* -1 until classified */
    int mode;               /* Port: the topic's ns_guard_mode */
} ViewObject;

/* Iterate the view's sid stream: calls ``fn(sid, snaps, n_snaps, window,
 * arg)`` per sid (sharded pairs resolve their per-shard snaps first),
 * skipping (Port) the sids the namespace guard drops for the view's
 * topic — so materialize, targets, len, has_shared and has_inline all
 * see the guarded stream. Returns 0 ok, -1 error. */
typedef int (*sid_fn)(int64_t sid, PyObject *snaps, Py_ssize_t n_snaps,
                      long long window, void *arg);

static int
view_for_each_sid(ViewObject *self, sid_fn fn, void *arg)
{
    BatchObject *b = self->batch;
    const int32_t *data = (const int32_t *)b->buf.buf;
    if (self->flags == 0 && self->materialized == NULL)
        return 0; /* classified-empty view: nothing to walk */
    if (b->mode == VIEW_MODE_PAIRS) {
        const int32_t *shards =
            b->sharded ? (const int32_t *)b->shards_buf.buf : NULL;
        Py_ssize_t n_shards = b->sharded ? PyList_GET_SIZE(b->snaps) : 0;
        for (Py_ssize_t k = 0; k < self->count; k++) {
            Py_ssize_t j = self->start + k;
            PyObject *snaps = b->snaps;
            if (shards != NULL) {
                int32_t s = shards[j];
                if (s < 0 || s >= n_shards) {
                    PyErr_SetString(PyExc_ValueError,
                                    "pair shard id out of range");
                    return -1;
                }
                snaps = PyList_GET_ITEM(b->snaps, s); /* borrowed */
                if (!PyList_Check(snaps)) {
                    PyErr_SetString(PyExc_TypeError,
                                    "sharded snaps must be a list of lists");
                    return -1;
                }
            }
            if (self->mode > 0) {
                int g = sid_guarded(data[j], snaps, PyList_GET_SIZE(snaps),
                                    b->window, self->mode);
                if (g < 0)
                    return -1;
                if (g)
                    continue;
            }
            if (fn(data[j], snaps, PyList_GET_SIZE(snaps), b->window,
                   arg) < 0)
                return -1;
        }
        return 0;
    }
    /* ranges: row = (P starts | P counts | total | overflow) */
    {
        const int32_t *row = data + self->start;
        Py_ssize_t P = b->P;
        Py_ssize_t n_snaps = PyList_GET_SIZE(b->snaps);
        for (Py_ssize_t p = 0; p < P; p++) {
            int32_t cnt = row[P + p];
            if (cnt <= 0)
                continue;
            int64_t s0 = row[p];
            for (int32_t k = 0; k < cnt; k++) {
                if (self->mode > 0) {
                    int g = sid_guarded(s0 + k, b->snaps, n_snaps, b->window,
                                        self->mode);
                    if (g < 0)
                        return -1;
                    if (g)
                        continue;
                }
                if (fn(s0 + k, b->snaps, n_snaps, b->window, arg) < 0)
                    return -1;
            }
        }
    }
    return 0;
}

/* -- classification: which hit kinds exist, without building anything -- */

static int
classify_cb(int64_t sid, PyObject *snaps, Py_ssize_t n_snaps,
            long long window, void *arg)
{
    int *flags = (int *)arg;
    int64_t ordinal = sid / window;
    int64_t local = sid % window;
    if (sid < 0 || ordinal >= n_snaps)
        return 0; /* out-of-range: skipped everywhere */
    PyObject *snap = PyList_GET_ITEM(snaps, ordinal);
    if (!PyTuple_Check(snap) || PyTuple_GET_SIZE(snap) != 3) {
        PyErr_SetString(PyExc_TypeError, "snapshot entries must be 3-tuples");
        return -1;
    }
    Py_ssize_t n_cli = PyTuple_GET_SIZE(PyTuple_GET_ITEM(snap, 0));
    Py_ssize_t n_shr = PyTuple_GET_SIZE(PyTuple_GET_ITEM(snap, 1));
    Py_ssize_t n_inl = PyTuple_GET_SIZE(PyTuple_GET_ITEM(snap, 2));
    if (local < n_cli)
        *flags |= VIEW_HAS_CLIENT;
    else if (local < n_cli + n_shr)
        *flags |= VIEW_HAS_SHARED;
    else if (local < n_cli + n_shr + n_inl)
        *flags |= VIEW_HAS_INLINE;
    return 0;
}

static int
view_classify(ViewObject *self)
{
    if (self->flags >= 0)
        return self->flags;
    int flags = 0;
    int prev = self->flags;
    self->flags = 1 << 14; /* sentinel: classification in progress (keeps
                            * for_each's empty-view fast path off) */
    if (view_for_each_sid(self, classify_cb, &flags) < 0) {
        self->flags = prev;
        return -1;
    }
    self->flags = flags;
    return flags;
}

/* -- materialization: the exact eager merge loop ------------------------ */

typedef struct {
    PyObject *subscriptions, *shared, *inline_subs;
} MergeCtx;

static int
merge_cb(int64_t sid, PyObject *snaps, Py_ssize_t n_snaps, long long window,
         void *arg)
{
    MergeCtx *ctx = (MergeCtx *)arg;
    /* the view's walk has already applied the guard */
    return merge_sid(sid, snaps, n_snaps, window, 0, ctx->subscriptions,
                     ctx->shared, ctx->inline_subs);
}

static PyObject *
view_materialize(ViewObject *self, PyObject *Py_UNUSED(ignored))
{
    if (self->materialized != NULL) {
        Py_INCREF(self->materialized);
        return self->materialized;
    }
    BatchObject *b = self->batch;
    ResLayout *RL = res_layout_for((PyTypeObject *)b->cls);
    MergeCtx ctx;
    PyObject *subs_obj =
        new_result(b->cls, RL, &ctx.subscriptions, &ctx.shared,
                   &ctx.inline_subs);
    if (subs_obj == NULL)
        return NULL;
    int r = view_for_each_sid(self, merge_cb, &ctx);
    Py_DECREF(ctx.subscriptions);
    Py_DECREF(ctx.shared);
    Py_DECREF(ctx.inline_subs);
    if (r < 0) {
        Py_DECREF(subs_obj);
        return NULL;
    }
    stat_view_materializations++;
    Py_INCREF(subs_obj);
    self->materialized = subs_obj;
    return subs_obj;
}

/* -- targets(): the lazy fan-out plan ----------------------------------- */

/* Hybrid duplicate-client detection: fan-outs up to this many UNIQUE
 * clients dedupe by a pointer-first linear scan over the plan (client
 * id strings are shared by reference from the session, so the pointer
 * probe almost always decides; value equality is the fallback, keeping
 * the eager dict's semantics exactly) — no per-hit dict probe, no
 * PyLong index, no set bookkeeping. Larger fan-outs migrate to the
 * dict once, then proceed as before. */
#define TARGETS_LINEAR_MAX 32

typedef struct {
    PyObject *out;      /* list of (client, subscription) tuples */
    PyObject *seen;     /* client -> index into out (NULL while linear) */
    PyObject *copied;   /* clients whose entry holds a copy (dict mode) */
    uint64_t copied_mask; /* entry-index bitmask (linear mode) */
    Py_hash_t hashes[TARGETS_LINEAR_MAX + 1]; /* entry client hashes */
    PyObject *pooled;   /* the view's pool-handout tracking list */
} TargetsCtx;

/* Mark entry ``i`` (holding ``client``) as carrying a copy. */
static int
targets_mark_copied(TargetsCtx *ctx, Py_ssize_t i, PyObject *client)
{
    if (ctx->copied != NULL)
        return PySet_Add(ctx->copied, client);
    if (i < 64)
        ctx->copied_mask |= (uint64_t)1 << i;
    return 0;
}

static int
targets_was_copied(TargetsCtx *ctx, Py_ssize_t i, PyObject *client)
{
    if (ctx->copied != NULL)
        return PySet_Contains(ctx->copied, client);
    return i < 64 && ((ctx->copied_mask >> i) & 1) != 0;
}

/* Migrate the linear plan into dict mode (first time out grows past
 * TARGETS_LINEAR_MAX unique clients). Returns 0 ok, -1 error. */
static int
targets_go_dict(TargetsCtx *ctx)
{
    ctx->seen = PyDict_New();
    ctx->copied = PySet_New(NULL);
    if (ctx->seen == NULL || ctx->copied == NULL)
        return -1;
    Py_ssize_t n = PyList_GET_SIZE(ctx->out);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *tup = PyList_GET_ITEM(ctx->out, i);
        PyObject *client = PyTuple_GET_ITEM(tup, 0);
        PyObject *idx = PyLong_FromSsize_t(i);
        if (idx == NULL)
            return -1;
        int r = PyDict_SetItem(ctx->seen, client, idx);
        Py_DECREF(idx);
        if (r < 0)
            return -1;
        if (i < 64 && (ctx->copied_mask >> i) & 1) {
            if (PySet_Add(ctx->copied, client) < 0)
                return -1;
        }
    }
    return 0;
}

/* One client-kind hit into the plan. First sighting hands the STORED
 * subscription (borrowed into the tuple — no copy): for delivery this is
 * value-identical to the eager first-sighting copy WHEN the subscription
 * carries no identifier state (identifiers map absent and identifier
 * == 0 — the overwhelmingly common case); otherwise the eager copy
 * semantics are observable ([MQTT-3.3.4-3] identifier materialization,
 * shared-and-extended maps), so those take the pooled copy immediately.
 * Duplicate sightings replay the eager sequence exactly:
 * self_merged_copy then merge. */
static int
targets_cb(int64_t sid, PyObject *snaps, Py_ssize_t n_snaps,
           long long window, void *arg)
{
    TargetsCtx *ctx = (TargetsCtx *)arg;
    int64_t ordinal = sid / window;
    int64_t local = sid % window;
    if (sid < 0 || ordinal >= n_snaps)
        return 0;
    PyObject *snap = PyList_GET_ITEM(snaps, ordinal);
    if (!PyTuple_Check(snap) || PyTuple_GET_SIZE(snap) != 3) {
        PyErr_SetString(PyExc_TypeError, "snapshot entries must be 3-tuples");
        return -1;
    }
    PyObject *cli = PyTuple_GET_ITEM(snap, 0);
    if (local >= PyTuple_GET_SIZE(cli))
        return 0; /* shared/inline/out-of-range: not a client target */
    PyObject *pair = PyTuple_GET_ITEM(cli, local);
    PyObject *client = PyTuple_GET_ITEM(pair, 0);
    PyObject *sub = PyTuple_GET_ITEM(pair, 1);
    Py_ssize_t found = -1;
    if (ctx->seen == NULL) {
        /* linear mode: hash-gated scan (str caches its hash, so this
         * is one int compare per existing entry in the common
         * all-distinct case; pointer/value compare only on collision —
         * value equality preserved, same dedupe truth as the dict) */
        Py_hash_t h = PyObject_Hash(client);
        if (h == -1 && PyErr_Occurred())
            return -1;
        Py_ssize_t n = PyList_GET_SIZE(ctx->out);
        for (Py_ssize_t k = 0; k < n; k++) {
            if (ctx->hashes[k] != h)
                continue;
            PyObject *c2 =
                PyTuple_GET_ITEM(PyList_GET_ITEM(ctx->out, k), 0);
            if (c2 == client) {
                found = k;
                break;
            }
            int eq = PyObject_RichCompareBool(c2, client, Py_EQ);
            if (eq < 0)
                return -1;
            if (eq) {
                found = k;
                break;
            }
        }
        if (found < 0 && n >= TARGETS_LINEAR_MAX) {
            if (targets_go_dict(ctx) < 0)
                return -1;
        }
        else if (found < 0) {
            ctx->hashes[n] = h; /* the slot the append below will take */
        }
    }
    if (ctx->seen != NULL && found < 0) {
        PyObject *idx = PyDict_GetItemWithError(ctx->seen, client);
        if (idx == NULL) {
            if (PyErr_Occurred())
                return -1;
        }
        else {
            found = PyLong_AsSsize_t(idx);
            if (found == -1 && PyErr_Occurred())
                return -1;
        }
    }
    if (found < 0) {
        SubLayout *L = sub_layout_for(Py_TYPE(sub));
        PyObject *entry_sub;
        int owned = 0;
        Py_ssize_t n = PyList_GET_SIZE(ctx->out);
        if (L != NULL && L->ok) {
            PyObject *ids = SLOT_AT(sub, L->ids_off);
            PyObject *ident = SLOT_AT(sub, L->ident_off);
            long idv = 0;
            if (ident != NULL) {
                idv = PyLong_AsLong(ident);
                if (idv == -1 && PyErr_Occurred())
                    return -1;
            }
            if ((ids == NULL || ids == Py_None) && idv == 0) {
                entry_sub = sub; /* borrowed: no identifier state */
            }
            else {
                entry_sub = first_sighting_pooled(sub, ctx->pooled);
                if (entry_sub == NULL)
                    return -1;
                owned = 1;
                if (targets_mark_copied(ctx, n, client) < 0) {
                    Py_DECREF(entry_sub);
                    return -1;
                }
            }
        }
        else {
            entry_sub =
                PyObject_CallMethodNoArgs(sub, s_self_merged_copy);
            if (entry_sub == NULL)
                return -1;
            owned = 1;
            if (targets_mark_copied(ctx, n, client) < 0) {
                Py_DECREF(entry_sub);
                return -1;
            }
        }
        PyObject *tup = PyTuple_New(2);
        if (tup == NULL) {
            if (owned)
                Py_DECREF(entry_sub);
            return -1;
        }
        Py_INCREF(client);
        PyTuple_SET_ITEM(tup, 0, client);
        if (!owned)
            Py_INCREF(entry_sub);
        PyTuple_SET_ITEM(tup, 1, entry_sub);
        if (PyList_Append(ctx->out, tup) < 0) {
            Py_DECREF(tup);
            return -1;
        }
        Py_DECREF(tup);
        if (ctx->seen != NULL) {
            PyObject *n_obj = PyLong_FromSsize_t(n);
            if (n_obj == NULL)
                return -1;
            int r = PyDict_SetItem(ctx->seen, client, n_obj);
            Py_DECREF(n_obj);
            return r;
        }
        return 0;
    }
    /* duplicate sighting: replay the eager merge sequence */
    Py_ssize_t i = found;
    PyObject *tup = PyList_GET_ITEM(ctx->out, i); /* borrowed */
    PyObject *prev = PyTuple_GET_ITEM(tup, 1);
    int was_copied = targets_was_copied(ctx, i, client);
    if (was_copied < 0)
        return -1;
    PyObject *base;
    if (!was_copied) {
        base = first_sighting_pooled(prev, ctx->pooled);
        if (base == NULL)
            return -1;
        if (targets_mark_copied(ctx, i, client) < 0) {
            Py_DECREF(base);
            return -1;
        }
    }
    else {
        Py_INCREF(prev);
        base = prev;
    }
    PyObject *merged = PyObject_CallMethodObjArgs(base, s_merge, sub, NULL);
    Py_DECREF(base);
    if (merged == NULL)
        return -1;
    PyObject *newtup = PyTuple_New(2);
    if (newtup == NULL) {
        Py_DECREF(merged);
        return -1;
    }
    Py_INCREF(client);
    PyTuple_SET_ITEM(newtup, 0, client);
    PyTuple_SET_ITEM(newtup, 1, merged); /* steals */
    if (PyList_SetItem(ctx->out, i, newtup) < 0) { /* steals newtup */
        return -1;
    }
    return 0;
}

static PyObject *
view_targets(ViewObject *self, PyObject *Py_UNUSED(ignored))
{
    /* no up-front classification: the plan walk skips shared/inline
     * hits itself, so an unclassified view pays ONE pass (the server
     * consults has_shared first anyway, which caches the flags) */
    int flags = self->flags;
    TargetsCtx ctx;
    ctx.out = PyList_New(0);
    ctx.seen = NULL;   /* linear dedupe until the plan outgrows it */
    ctx.copied = NULL;
    ctx.copied_mask = 0;
    if (self->pooled == NULL)
        self->pooled = PyList_New(0);
    ctx.pooled = self->pooled;
    if (ctx.out == NULL || ctx.pooled == NULL) {
        Py_XDECREF(ctx.out);
        return NULL;
    }
    int r = (flags != 0)  /* 0 = classified-empty; -1 = walk blind */
                ? view_for_each_sid(self, targets_cb, &ctx)
                : 0;
    Py_XDECREF(ctx.seen);
    Py_XDECREF(ctx.copied);
    if (r < 0) {
        Py_DECREF(ctx.out);
        return NULL;
    }
    return ctx.out;
}

/* -- attribute surface -------------------------------------------------- */

static PyObject *
view_get_has_shared(ViewObject *self, void *Py_UNUSED(closure))
{
    int flags = view_classify(self);
    if (flags < 0)
        return NULL;
    return PyBool_FromLong(flags & VIEW_HAS_SHARED);
}

static PyObject *
view_get_has_inline(ViewObject *self, void *Py_UNUSED(closure))
{
    int flags = view_classify(self);
    if (flags < 0)
        return NULL;
    return PyBool_FromLong(flags & VIEW_HAS_INLINE);
}

static PyObject *
view_get_is_lazy(ViewObject *self, void *Py_UNUSED(closure))
{
    /* True until someone forced materialization — observability only */
    return PyBool_FromLong(self->materialized == NULL);
}

/* The four Subscribers attributes delegate to the materialized result:
 * any legacy consumer (predicates engine, resilience differential,
 * shared-group selection) transparently gets full eager semantics. */
static PyObject *
view_delegate_attr(ViewObject *self, PyObject *name)
{
    PyObject *m = view_materialize(self, NULL);
    if (m == NULL)
        return NULL;
    PyObject *v = PyObject_GetAttr(m, name);
    Py_DECREF(m);
    return v;
}

static PyObject *
view_getattro(PyObject *obj, PyObject *name)
{
    PyObject *v = PyObject_GenericGetAttr(obj, name);
    if (v != NULL || !PyErr_ExceptionMatches(PyExc_AttributeError))
        return v;
    /* unknown attribute: fall through to the materialized Subscribers
     * (select_shared, merge_shared_selected, future additions) */
    PyErr_Clear();
    return view_delegate_attr((ViewObject *)obj, name);
}

static int
view_setattro(PyObject *obj, PyObject *name, PyObject *value)
{
    /* e.g. ``subscribers.shared_selected = {}`` from select_shared when
     * a consumer drives the view like a plain Subscribers */
    ViewObject *self = (ViewObject *)obj;
    PyObject *m = view_materialize(self, NULL);
    if (m == NULL)
        return -1;
    int r = PyObject_SetAttr(m, name, value);
    Py_DECREF(m);
    return r;
}

static int
count_cb(int64_t Py_UNUSED(sid), PyObject *Py_UNUSED(snaps),
         Py_ssize_t Py_UNUSED(n_snaps), long long Py_UNUSED(window),
         void *arg)
{
    (*(Py_ssize_t *)arg)++;
    return 0;
}

static Py_ssize_t
view_len(PyObject *obj)
{
    ViewObject *self = (ViewObject *)obj;
    if (self->mode > 0) {
        /* Port: a scoped topic counts the hits the guard keeps */
        Py_ssize_t kept = 0;
        int prev = self->flags;
        self->flags = 1 << 14; /* keep for_each's empty-view path off */
        int r = view_for_each_sid(self, count_cb, &kept);
        self->flags = prev;
        return r < 0 ? -1 : kept;
    }
    if (self->batch->mode == VIEW_MODE_PAIRS)
        return self->count;
    const int32_t *row =
        (const int32_t *)self->batch->buf.buf + self->start;
    Py_ssize_t P = self->batch->P;
    Py_ssize_t total = 0;
    for (Py_ssize_t p = 0; p < P; p++)
        if (row[P + p] > 0)
            total += row[P + p];
    return total;
}

static void
view_dealloc(ViewObject *self)
{
    /* recycle pool handouts the world has let go of: refcount 1 here
     * means only our tracking list still references the copy, so parking
     * it can never create an aliased (use-after-recycle) object */
    if (self->pooled != NULL) {
        Py_ssize_t n = PyList_GET_SIZE(self->pooled);
        for (Py_ssize_t i = 0; i < n; i++) {
            PyObject *o = PyList_GET_ITEM(self->pooled, i); /* borrowed */
            if (Py_REFCNT(o) == 1) {
                Py_INCREF(o); /* working ref across the swap */
                Py_INCREF(Py_None);
                /* PyList_SetItem (not the macro): the list's own ref to
                 * the parked object must be RELEASED here, or every
                 * recycle leaks one count and the object can never park
                 * again */
                PyList_SetItem(self->pooled, i, Py_None);
                pool_put(o); /* consumes the working ref */
            }
        }
    }
    Py_XDECREF(self->pooled);
    Py_XDECREF(self->materialized);
    Py_XDECREF((PyObject *)self->batch);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyMethodDef view_methods[] = {
    {"materialize", (PyCFunction)view_materialize, METH_NOARGS,
     "The eager Subscribers result (cached; bit-identical to the "
     "non-lazy path)."},
    {"targets", (PyCFunction)view_targets, METH_NOARGS,
     "The lazy fan-out plan: [(client_id, Subscription), ...] for "
     "client-kind hits, deduped with eager merge semantics."},
    {NULL, NULL, 0, NULL},
};

static PyGetSetDef view_getset[] = {
    {"has_shared", (getter)view_get_has_shared, NULL,
     "Any shared-group hits in this view (cheap scan, no objects).",
     NULL},
    {"has_inline", (getter)view_get_has_inline, NULL,
     "Any inline-subscription hits in this view.", NULL},
    {"is_lazy", (getter)view_get_is_lazy, NULL,
     "True until a consumer forced materialization.", NULL},
    {NULL, NULL, NULL, NULL, NULL},
};

static PySequenceMethods view_as_sequence = {
    .sq_length = view_len,
};

static PyTypeObject ViewType = {
    PyVarObject_HEAD_INIT(NULL, 0)
    .tp_name = "mqtt_torch_accel.SubscribersView",
    .tp_basicsize = sizeof(ViewObject),
    .tp_dealloc = (destructor)view_dealloc,
    .tp_getattro = view_getattro,
    .tp_setattro = view_setattro,
    .tp_as_sequence = &view_as_sequence,
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_methods = view_methods,
    .tp_getset = view_getset,
    .tp_doc = "Zero-copy lazy view over one topic's device match hits.",
};

static ViewObject *
view_new(BatchObject *batch, Py_ssize_t start, Py_ssize_t count, int mode)
{
    ViewObject *v = PyObject_New(ViewObject, &ViewType);
    if (v == NULL)
        return NULL;
    Py_INCREF((PyObject *)batch);
    v->batch = batch;
    v->start = start;
    v->count = count;
    v->materialized = NULL;
    v->pooled = NULL;
    v->flags = count == 0 ? 0 : -1;
    v->mode = mode;
    stat_views_created++;
    return v;
}

/* resolve_compact_views(sids, shards, totals, route, n_hits, n_topics,
 *                       snaps, window, subscribers_cls, modes=None)
 * The lazy twin of resolve_compact: identical geometry checks and routing,
 * but results[i] is a SubscribersView over the pair stream instead of a
 * materialized Subscribers. */
static PyObject *
resolve_compact_views(PyObject *Py_UNUSED(self), PyObject *args)
{
    PyObject *sids_obj, *shards_obj, *totals_obj, *route_obj, *snaps,
        *subscribers_cls, *modes_obj = Py_None;
    Py_ssize_t n_hits, n_topics;
    long long window;
    if (!PyArg_ParseTuple(args, "OOOOnnOLO|O", &sids_obj, &shards_obj,
                          &totals_obj, &route_obj, &n_hits, &n_topics,
                          &snaps, &window, &subscribers_cls, &modes_obj))
        return NULL;
    if (!PyList_Check(snaps)) {
        PyErr_SetString(PyExc_TypeError, "snaps must be a list");
        return NULL;
    }
    if (window <= 0 || n_hits < 0 || n_topics < 0 ||
        !PyType_Check(subscribers_cls)) {
        PyErr_SetString(PyExc_ValueError,
                        "window must be > 0, counts >= 0, cls a type");
        return NULL;
    }
    Py_buffer totals_v, route_v, modes_v;
    totals_v.buf = route_v.buf = NULL;
    const int8_t *modes;
    PyObject *results = NULL, *overflow_idx = NULL, *out = NULL;
    BatchObject *batch = NULL;
    if (get_modes(modes_obj, &modes_v, n_topics, &modes) < 0)
        return NULL;
    if (PyObject_GetBuffer(totals_obj, &totals_v, PyBUF_C_CONTIGUOUS) < 0) {
        if (modes_v.buf != NULL)
            PyBuffer_Release(&modes_v);
        return NULL;
    }
    if (PyObject_GetBuffer(route_obj, &route_v, PyBUF_C_CONTIGUOUS) < 0)
        goto done;
    if (totals_v.itemsize != 4 || route_v.itemsize != 4) {
        PyErr_SetString(PyExc_ValueError, "buffers must be int32");
        goto done;
    }
    batch = batch_new(sids_obj, shards_obj, snaps, subscribers_cls, window,
                      0, VIEW_MODE_PAIRS);
    if (batch == NULL)
        goto done;
    {
        Py_ssize_t B = totals_v.len / 4;
        Py_ssize_t n_sids = batch->buf.len / 4;
        if (route_v.len / 4 < B || n_topics > B || n_hits > n_sids ||
            (batch->sharded && batch->shards_buf.len / 4 < n_sids)) {
            PyErr_SetString(PyExc_ValueError,
                            "compact buffers disagree on batch geometry");
            goto done;
        }
        const int32_t *totals = (const int32_t *)totals_v.buf;
        const int32_t *route = (const int32_t *)route_v.buf;
        results = PyList_New(n_topics);
        overflow_idx = PyList_New(0);
        if (results == NULL || overflow_idx == NULL)
            goto done;
        Py_ssize_t cursor = 0;
        for (Py_ssize_t i = 0; i < B; i++) {
            int32_t t = totals[i];
            if (t < 0 || cursor + t > n_hits) {
                PyErr_SetString(PyExc_ValueError,
                                "compact totals overrun the pair stream");
                goto done;
            }
            if (i >= n_topics || route[i]) {
                if (i < n_topics) {
                    PyObject *idx = PyLong_FromSsize_t(i);
                    if (idx == NULL ||
                        PyList_Append(overflow_idx, idx) < 0) {
                        Py_XDECREF(idx);
                        goto done;
                    }
                    Py_DECREF(idx);
                    Py_INCREF(Py_None);
                    PyList_SET_ITEM(results, i, Py_None);
                }
                cursor += t;
                continue;
            }
            ViewObject *v = view_new(batch, cursor, t, MODE_AT(modes, i));
            if (v == NULL)
                goto done;
            PyList_SET_ITEM(results, i, (PyObject *)v); /* steals */
            cursor += t;
        }
        if (cursor != n_hits) {
            PyErr_SetString(PyExc_ValueError,
                            "compact pair stream and totals disagree");
            goto done;
        }
    }
    out = PyTuple_Pack(2, results, overflow_idx);

done:
    if (modes_v.buf != NULL)
        PyBuffer_Release(&modes_v);
    if (totals_v.buf != NULL)
        PyBuffer_Release(&totals_v);
    if (route_v.buf != NULL)
        PyBuffer_Release(&route_v);
    Py_XDECREF((PyObject *)batch);
    Py_XDECREF(results);
    Py_XDECREF(overflow_idx);
    return out;
}

/* resolve_batch_views(packed, n_topics, P, snaps, window, subscribers_cls,
 *                     modes=None)
 * The lazy twin of resolve_batch over the padded-ranges encoding: each
 * non-overflow row becomes a SubscribersView that expands its synthetic
 * sid ranges on demand. */
static PyObject *
resolve_batch_views(PyObject *Py_UNUSED(self), PyObject *args)
{
    PyObject *packed_obj, *snaps, *subscribers_cls, *modes_obj = Py_None;
    Py_ssize_t n_topics, P;
    long long window;
    if (!PyArg_ParseTuple(args, "OnnOLO|O", &packed_obj, &n_topics, &P,
                          &snaps, &window, &subscribers_cls, &modes_obj))
        return NULL;
    if (!PyList_Check(snaps)) {
        PyErr_SetString(PyExc_TypeError, "snaps must be a list");
        return NULL;
    }
    if (window <= 0 || P < 0 || !PyType_Check(subscribers_cls)) {
        PyErr_SetString(PyExc_ValueError,
                        "window must be > 0, P >= 0, cls a type");
        return NULL;
    }
    Py_buffer modes_v;
    const int8_t *modes;
    if (get_modes(modes_obj, &modes_v, n_topics, &modes) < 0)
        return NULL;
    BatchObject *batch = batch_new(packed_obj, NULL, snaps,
                                   subscribers_cls, window, P,
                                   VIEW_MODE_RANGES);
    Py_ssize_t row_ints = 2 * P + 2;
    PyObject *results = NULL, *overflow_idx = NULL, *out = NULL;
    if (batch == NULL)
        goto done;
    if (batch->buf.len <
        n_topics * row_ints * (Py_ssize_t)sizeof(int32_t)) {
        PyErr_SetString(PyExc_ValueError,
                        "packed buffer must be int32 [n_topics, 2P+2]");
        goto done;
    }
    results = PyList_New(n_topics);
    overflow_idx = PyList_New(0);
    if (results == NULL || overflow_idx == NULL)
        goto done;
    {
        const int32_t *data = (const int32_t *)batch->buf.buf;
        for (Py_ssize_t i = 0; i < n_topics; i++) {
            const int32_t *row = data + i * row_ints;
            if (row[2 * P + 1]) { /* overflow: host re-walk decides */
                PyObject *idx = PyLong_FromSsize_t(i);
                if (idx == NULL || PyList_Append(overflow_idx, idx) < 0) {
                    Py_XDECREF(idx);
                    goto done;
                }
                Py_DECREF(idx);
                Py_INCREF(Py_None);
                PyList_SET_ITEM(results, i, Py_None);
                continue;
            }
            ViewObject *v = view_new(batch, i * row_ints, -1,
                                     MODE_AT(modes, i));
            if (v == NULL)
                goto done;
            v->flags = -1; /* ranges rows always classify lazily */
            PyList_SET_ITEM(results, i, (PyObject *)v); /* steals */
        }
    }
    out = PyTuple_Pack(2, results, overflow_idx);

done:
    if (modes_v.buf != NULL)
        PyBuffer_Release(&modes_v);
    Py_XDECREF((PyObject *)batch);
    Py_XDECREF(results);
    Py_XDECREF(overflow_idx);
    return out;
}

/* view_stats() -> dict: module-lifetime view/pool accounting (the server
 * exports these as mqtt_tpu_fanout_view_materializations_total etc.). */
static PyObject *
view_stats(PyObject *Py_UNUSED(self), PyObject *Py_UNUSED(ignored))
{
    return Py_BuildValue(
        "{s:L,s:L,s:L,s:L,s:i,s:L,s:L,s:L,s:L}",
        "views", stat_views_created,
        "materializations", stat_view_materializations,
        "pool_hits", stat_pool_hits,
        "pool_returns", stat_pool_returns,
        "pool_size", sub_pool_n,
        /* Port: which path built each result and each first-sighting copy */
        "slot_results", stat_slot_results,
        "generic_results", stat_generic_results,
        "slot_copies", stat_slot_copies,
        "method_copies", stat_method_copies);
}

/* pool_clear() — drop every parked instance (tests; also lets an
 * embedder release the pool's references at shutdown). */
static PyObject *
pool_clear(PyObject *Py_UNUSED(self), PyObject *Py_UNUSED(ignored))
{
    while (sub_pool_n > 0)
        Py_DECREF(sub_pool[--sub_pool_n]);
    Py_RETURN_NONE;
}

static PyMethodDef methods[] = {
    {"resolve_batch", resolve_batch, METH_VARARGS,
     "Expand packed device range rows into Subscribers results."},
    {"resolve_compact_views", resolve_compact_views, METH_VARARGS,
     "Lazy twin of resolve_compact: SubscribersView results over the "
     "pair stream."},
    {"resolve_batch_views", resolve_batch_views, METH_VARARGS,
     "Lazy twin of resolve_batch: SubscribersView results over the "
     "ranges rows."},
    {"view_stats", view_stats, METH_NOARGS,
     "View/pool accounting counters (module lifetime)."},
    {"pool_clear", pool_clear, METH_NOARGS,
     "Drop every parked freelist instance."},
    {"resolve_compact", resolve_compact, METH_VARARGS,
     "Expand a device-compacted (topic-major) pair stream into "
     "Subscribers results."},
    {"expand_sids_list", expand_sids_list, METH_VARARGS,
     "Merge an explicit sid list into an existing Subscribers instance."},
    {"expand_snap", expand_snap, METH_VARARGS,
     "Materialize one node snapshot tuple into a Subscribers result."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "mqtt_torch_accel",
    "C materializer for device match results (see accelmod.c).", -1, methods,
    NULL, NULL, NULL, NULL,
};

PyMODINIT_FUNC
PyInit_mqtt_torch_accel(void) /* Port: the module's own name */
{
    s_merge = PyUnicode_InternFromString("merge");
    s_filter = PyUnicode_InternFromString("filter");
    s_identifier = PyUnicode_InternFromString("identifier");
    s_identifiers = PyUnicode_InternFromString("identifiers");
    s_subscriptions = PyUnicode_InternFromString("subscriptions");
    s_shared = PyUnicode_InternFromString("shared");
    s_shared_selected = PyUnicode_InternFromString("shared_selected");
    s_inline_subscriptions =
        PyUnicode_InternFromString("inline_subscriptions");
    s_self_merged_copy = PyUnicode_InternFromString("self_merged_copy");
    if (!s_merge || !s_filter || !s_identifier || !s_identifiers ||
        !s_subscriptions || !s_shared || !s_shared_selected ||
        !s_inline_subscriptions || !s_self_merged_copy)
        return NULL;
    if (PyType_Ready(&BatchType) < 0 || PyType_Ready(&ViewType) < 0)
        return NULL;
    PyObject *mod = PyModule_Create(&moduledef);
    if (mod == NULL)
        return NULL;
    Py_INCREF((PyObject *)&ViewType);
    if (PyModule_AddObject(mod, "SubscribersView",
                           (PyObject *)&ViewType) < 0) {
        Py_DECREF((PyObject *)&ViewType);
        Py_DECREF(mod);
        return NULL;
    }
    return mod;
}
