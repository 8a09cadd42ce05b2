/* fastpath: C implementations of the scheduler's hottest host loops.
 *
 * The session solve itself runs on the device (ops/solver.py); what remains on
 * the host critical path at 50k tasks x 10k nodes is pure Python
 * bytecode dispatch over per-task object work.  This module is the
 * native runtime piece of that path (SURVEY.md section 2.2 notes the
 * reference fans the equivalent loop over 16 goroutines,
 * util/scheduler_helper.go:84):
 *
 *   apply_placements(jobs, nodes, placements, allocate_volumes)
 *     -> (applied, skipped, touched_jobs, alloc_moves, pipe_moves)
 *
 * performs pass 1 of Session.batch_apply (framework/session.py): per
 * placement (task, hostname, kind) resolve job/node, duplicate-check
 * against node.tasks, optionally bind volumes, stamp task.node_name,
 * insert task.clone_lite() into node.tasks, and bucket the task for the
 * deferred status-index moves.
 *
 *   assume_walk, assume_group, assume_insert
 *
 * do the same for the cache's mirror of a batch of binds
 * (cache/assume.py): the walk over the batch, and each node's sums and
 * inserts.  Behavior is bit-identical to the Python loops they replace;
 * kube_batch_tpu_torch/native/__init__.py falls back to those loops when
 * this extension cannot be built.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <structmember.h>
#include <math.h>

/* Exception-free attribute probe (returns -1 err / 0 missing / 1 found
 * with a new ref in *result): a missed PyObject_GetAttr materializes an
 * AttributeError per miss, which costs more than the work these fast
 * paths replace.  CPython 3.13 made this public as
 * PyObject_GetOptionalAttr; on 3.12 and older the same function is
 * exported (but undeclared) as _PyObject_LookupAttr. */
#if PY_VERSION_HEX >= 0x030D0000
#define LOOKUP_ATTR PyObject_GetOptionalAttr
#else
extern int _PyObject_LookupAttr(PyObject *, PyObject *, PyObject **);
#define LOOKUP_ATTR _PyObject_LookupAttr
#endif

/* Cached attribute-name objects (created once at module init). */
static PyObject *s_job, *s_pod, *s_spec, *s_volumes, *s_node_name,
    *s_name, *s_tasks, *s_clone_lite, *s_pod_key_cache, *s_metadata,
    *s_namespace, *s_lazy, *s_status, *s_uid;

/* TaskInfo slot layout, resolved once from the first task's type: the
 * member-descriptor offsets let the clone run as 11 pointer copies
 * instead of a Python method call, and job/pod/node_name reads skip the
 * descriptor protocol.  Falls back to generic attribute access when the
 * layout doesn't match (e.g. a TaskInfo subclass with extra slots). */
#define N_SLOTS 11
static const char *SLOT_NAMES[N_SLOTS] = {
    "uid", "job", "name", "namespace", "resreq", "init_resreq",
    "node_name", "status", "priority", "volume_ready", "pod",
};
enum { SL_UID, SL_JOB, SL_NAME, SL_NAMESPACE, SL_RESREQ, SL_INIT_RESREQ,
       SL_NODE_NAME, SL_STATUS, SL_PRIORITY, SL_VOLUME_READY, SL_POD };

typedef struct {
    PyTypeObject *type;        /* borrowed sentinel; NULL = unresolved */
    int valid;
    Py_ssize_t offsets[N_SLOTS];
} TaskLayout;

static TaskLayout layout = {NULL, 0, {0}};

static void
resolve_layout(PyTypeObject *tp)
{
    layout.type = tp;
    layout.valid = 0;
    if (tp->tp_itemsize != 0 || tp->tp_dictoffset != 0)
        return;  /* unexpected shape; use the generic path */
    for (int i = 0; i < N_SLOTS; i++) {
        PyObject *descr = PyObject_GetAttrString((PyObject *)tp,
                                                 SLOT_NAMES[i]);
        if (descr == NULL) {
            PyErr_Clear();
            return;
        }
        int is_member = (Py_TYPE(descr) == &PyMemberDescr_Type);
        PyMemberDef *m = is_member
            ? ((PyMemberDescrObject *)descr)->d_member : NULL;
        if (!is_member || m->type != T_OBJECT_EX) {
            Py_DECREF(descr);
            return;
        }
        layout.offsets[i] = m->offset;
        Py_DECREF(descr);
    }
    layout.valid = 1;
}

static inline PyObject *
slot_get(PyObject *obj, int slot)  /* borrowed ref or NULL (unset) */
{
    return *(PyObject **)((char *)obj + layout.offsets[slot]);
}

static PyObject *
clone_task_fast(PyObject *task)
{
    PyTypeObject *tp = Py_TYPE(task);
    PyObject *clone = tp->tp_alloc(tp, 0);
    if (clone == NULL)
        return NULL;
    for (int i = 0; i < N_SLOTS; i++) {
        PyObject *v = slot_get(task, i);
        if (v == NULL) {  /* unset slot: fall back to the Python clone */
            Py_DECREF(clone);
            return PyObject_CallMethodNoArgs(task, s_clone_lite);
        }
        Py_INCREF(v);
        *(PyObject **)((char *)clone + layout.offsets[i]) = v;
    }
    return clone;
}

static PyObject *
get_pod_key(PyObject *pod)
{
    /* pod._pod_key, computing and caching "ns/name" on first use —
     * mirrors api/objects.py pod_key(). */
    PyObject *key;
    if (LOOKUP_ATTR(pod, s_pod_key_cache, &key) < 0)
        return NULL;
    if (key != NULL)
        return key;
    PyObject *meta = PyObject_GetAttr(pod, s_metadata);
    if (meta == NULL)
        return NULL;
    PyObject *ns = PyObject_GetAttr(meta, s_namespace);
    PyObject *name = ns ? PyObject_GetAttr(meta, s_name) : NULL;
    Py_DECREF(meta);
    if (name == NULL) {
        Py_XDECREF(ns);
        return NULL;
    }
    key = PyUnicode_FromFormat("%U/%U", ns, name);
    Py_DECREF(ns);
    Py_DECREF(name);
    if (key == NULL)
        return NULL;
    if (PyObject_SetAttr(pod, s_pod_key_cache, key) < 0)
        PyErr_Clear();  /* uncacheable pod: still return the key */
    return key;
}

static int
append_skip(PyObject *skipped, PyObject *entry, PyObject *task,
            PyObject *hostname, PyObject *kind_obj)
{
    /* Tuple rows carry their entry; columnar rows materialize the
     * (task, hostname, kind) triple only when actually skipped. */
    if (entry != NULL)
        return PyList_Append(skipped, entry);
    PyObject *t = PyTuple_Pack(3, task, hostname, kind_obj);
    if (t == NULL)
        return -1;
    int rc = PyList_Append(skipped, t);
    Py_DECREF(t);
    return rc;
}

static PyObject *
apply_placements(PyObject *self, PyObject *args)
{
    PyObject *jobs, *nodes, *placements, *allocate_volumes;
    if (!PyArg_ParseTuple(args, "OOOO", &jobs, &nodes, &placements,
                          &allocate_volumes))
        return NULL;
    /* Columnar form (Session.batch_apply_solved): placements may be a
     * 3-tuple of equal-length lists (tasks, hostnames, kinds) instead
     * of a list of 3-tuples — same walk, no per-placement tuple
     * packing.  Skip entries are materialized as tuples on demand
     * (skips are rare). */
    PyObject *col_tasks = NULL, *col_hosts = NULL, *col_kinds = NULL;
    if (PyTuple_Check(placements) && PyTuple_GET_SIZE(placements) == 3) {
        col_tasks = PyTuple_GET_ITEM(placements, 0);
        col_hosts = PyTuple_GET_ITEM(placements, 1);
        col_kinds = PyTuple_GET_ITEM(placements, 2);
        if (!PyList_Check(col_tasks) || !PyList_Check(col_hosts)
            || !PyList_Check(col_kinds)
            || PyList_GET_SIZE(col_tasks) != PyList_GET_SIZE(col_hosts)
            || PyList_GET_SIZE(col_tasks) != PyList_GET_SIZE(col_kinds)) {
            PyErr_SetString(PyExc_TypeError,
                            "columnar placements must be three "
                            "equal-length lists");
            return NULL;
        }
    }
    if (!PyDict_Check(jobs) || !PyDict_Check(nodes)
        || (col_tasks == NULL && !PyList_Check(placements))) {
        PyErr_SetString(PyExc_TypeError,
                        "jobs/nodes must be dicts, placements a list "
                        "or a (tasks, hostnames, kinds) column tuple");
        return NULL;
    }

    /* hostname -> (node, node.tasks, node.name): placements revisit the
     * same node many times; resolve its attributes once.  Everything
     * the fail path decrefs is initialized before any goto. */
    PyObject *node_cache = NULL;
    PyObject *applied = PyList_New(0);
    PyObject *skipped = PyList_New(0);
    PyObject *touched = PyDict_New();   /* job uid -> job */
    PyObject *alloc_moves = PyDict_New();  /* job uid -> [tasks] */
    PyObject *pipe_moves = PyDict_New();
    if (!applied || !skipped || !touched || !alloc_moves || !pipe_moves)
        goto fail;
    node_cache = PyDict_New();
    if (node_cache == NULL)
        goto fail;

    Py_ssize_t n = col_tasks ? PyList_GET_SIZE(col_tasks)
                             : PyList_GET_SIZE(placements);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *entry = NULL, *task, *hostname, *kind_obj;
        if (col_tasks != NULL) {  /* columnar row: three parallel lists */
            task = PyList_GET_ITEM(col_tasks, i);      /* borrowed */
            hostname = PyList_GET_ITEM(col_hosts, i);  /* borrowed */
            kind_obj = PyList_GET_ITEM(col_kinds, i);  /* borrowed */
        } else {
            entry = PyList_GET_ITEM(placements, i);  /* borrowed */
            if (!PyTuple_Check(entry) || PyTuple_GET_SIZE(entry) != 3) {
                PyErr_SetString(PyExc_TypeError,
                                "placement entries must be 3-tuples");
                goto fail;
            }
            task = PyTuple_GET_ITEM(entry, 0);
            hostname = PyTuple_GET_ITEM(entry, 1);
            kind_obj = PyTuple_GET_ITEM(entry, 2);
        }
        long kind = PyLong_AsLong(kind_obj);
        if (kind == -1 && PyErr_Occurred())
            goto fail;

        if (layout.type != Py_TYPE(task))
            resolve_layout(Py_TYPE(task));
        int fast = layout.valid && Py_TYPE(task) == layout.type;

        /* owned refs for uniform cleanup */
        PyObject *job_uid = NULL, *pod = NULL, *key = NULL,
            *node_tasks = NULL;

        job_uid = fast ? slot_get(task, SL_JOB) : NULL;
        if (job_uid != NULL)
            Py_INCREF(job_uid);
        else {
            job_uid = PyObject_GetAttr(task, s_job);
            if (job_uid == NULL)
                goto fail;
        }
        PyObject *job = PyDict_GetItemWithError(jobs, job_uid); /* borrowed */
        if (job == NULL && PyErr_Occurred())
            goto fail_inner;

        PyObject *node = NULL, *node_name = NULL;  /* borrowed (cache) */
        PyObject *cached = PyDict_GetItemWithError(node_cache, hostname);
        if (cached == NULL) {
            if (PyErr_Occurred())
                goto fail_inner;
            node = PyDict_GetItemWithError(nodes, hostname); /* borrowed */
            if (node == NULL && PyErr_Occurred())
                goto fail_inner;
            if (node != NULL) {
                PyObject *tasks_o = PyObject_GetAttr(node, s_tasks);
                PyObject *name_o = tasks_o
                    ? PyObject_GetAttr(node, s_name) : NULL;
                if (name_o == NULL) {
                    Py_XDECREF(tasks_o);
                    goto fail_inner;
                }
                if (!PyDict_Check(tasks_o)) {
                    Py_DECREF(tasks_o);
                    Py_DECREF(name_o);
                    PyErr_SetString(PyExc_TypeError,
                                    "node.tasks not a dict");
                    goto fail_inner;
                }
                /* Lazy view probe (api/node_info.LazyTaskDict): a
                 * ``_lazy`` dict attr means inserts defer the clone —
                 * live task + insert-time status capture instead. */
                PyObject *pend = NULL;
                if (LOOKUP_ATTR(tasks_o, s_lazy, &pend) < 0) {
                    Py_DECREF(tasks_o);
                    Py_DECREF(name_o);
                    goto fail_inner;
                }
                if (pend == NULL || !PyDict_Check(pend)) {
                    Py_XDECREF(pend);
                    pend = Py_None;
                    Py_INCREF(pend);
                }
                cached = PyTuple_Pack(4, node, tasks_o, name_o, pend);
                Py_DECREF(tasks_o);
                Py_DECREF(name_o);
                Py_DECREF(pend);
                if (cached == NULL)
                    goto fail_inner;
                int rc = PyDict_SetItem(node_cache, hostname, cached);
                Py_DECREF(cached);
                if (rc < 0)
                    goto fail_inner;
            }
        } else {
            node = PyTuple_GET_ITEM(cached, 0);
        }
        if (job == NULL || node == NULL) {
            Py_DECREF(job_uid);
            if (append_skip(skipped, entry, task, hostname, kind_obj) < 0)
                goto fail;
            continue;
        }
        node_tasks = PyTuple_GET_ITEM(cached, 1);  /* borrowed */
        Py_INCREF(node_tasks);
        node_name = PyTuple_GET_ITEM(cached, 2);   /* borrowed */

        pod = fast ? slot_get(task, SL_POD) : NULL;
        if (pod != NULL)
            Py_INCREF(pod);
        else {
            pod = PyObject_GetAttr(task, s_pod);
            if (pod == NULL)
                goto fail_inner;
        }
        key = get_pod_key(pod);
        if (key == NULL)
            goto fail_inner;

        int dup = PyDict_Contains(node_tasks, key);
        if (dup < 0)
            goto fail_inner;
        if (dup) {  /* add_task would raise; mirror log-and-skip */
            Py_DECREF(node_tasks);
            Py_DECREF(key);
            Py_DECREF(pod);
            Py_DECREF(job_uid);
            if (append_skip(skipped, entry, task, hostname, kind_obj) < 0)
                goto fail;
            continue;
        }

        if (kind == 1) {
            /* Volume-bearing pods go through cache.allocate_volumes;
             * KeyError/ValueError skips the placement exactly as the
             * sequential path's per-task catch would. */
            PyObject *spec = PyObject_GetAttr(pod, s_spec);
            if (spec == NULL)
                goto fail_inner;
            PyObject *volumes = PyObject_GetAttr(spec, s_volumes);
            Py_DECREF(spec);
            if (volumes == NULL)
                goto fail_inner;
            int has_volumes = PyObject_IsTrue(volumes);
            Py_DECREF(volumes);
            if (has_volumes < 0)
                goto fail_inner;
            if (has_volumes) {
                PyObject *r = PyObject_CallFunctionObjArgs(
                    allocate_volumes, task, hostname, NULL);
                if (r == NULL) {
                    if (PyErr_ExceptionMatches(PyExc_KeyError)
                        || PyErr_ExceptionMatches(PyExc_ValueError)) {
                        PyErr_Clear();
                        Py_DECREF(node_tasks);
                        Py_DECREF(key);
                        Py_DECREF(pod);
                        Py_DECREF(job_uid);
                        if (append_skip(skipped, entry, task, hostname,
                                        kind_obj) < 0)
                            goto fail;
                        continue;
                    }
                    goto fail_inner;
                }
                Py_DECREF(r);
            }
        }

        /* task.node_name = node.name (before the clone/capture so it
         * carries the assignment), then node.tasks[key] =
         * task.clone_lite() — or, on a lazy view, the live task plus
         * its insert-time status (LazyTaskDict.lazy_set in C). */
        if (fast) {
            PyObject **slotp = (PyObject **)
                ((char *)task + layout.offsets[SL_NODE_NAME]);
            PyObject *old = *slotp;
            Py_INCREF(node_name);
            *slotp = node_name;
            Py_XDECREF(old);
        } else {
            if (PyObject_SetAttr(task, s_node_name, node_name) < 0)
                goto fail_inner;
        }
        PyObject *lazy_pend = PyTuple_GET_ITEM(cached, 3);  /* borrowed */
        if (lazy_pend != Py_None) {
            if (PyDict_SetItem(node_tasks, key, task) < 0)
                goto fail_inner;
            PyObject *status = fast ? slot_get(task, SL_STATUS) : NULL;
            int owned = 0;
            if (status == NULL) {
                status = PyObject_GetAttr(task, s_status);
                if (status == NULL)
                    goto fail_inner;
                owned = 1;
            }
            int rc = PyDict_SetItem(lazy_pend, key, status);
            if (owned)
                Py_DECREF(status);
            if (rc < 0)
                goto fail_inner;
        } else {
            PyObject *clone = fast
                ? clone_task_fast(task)
                : PyObject_CallMethodNoArgs(task, s_clone_lite);
            if (clone == NULL)
                goto fail_inner;
            int rc = PyDict_SetItem(node_tasks, key, clone);
            Py_DECREF(clone);
            if (rc < 0)
                goto fail_inner;
        }

        /* Bucket for the deferred status-index move. */
        {
            PyObject *moves = (kind == 1) ? alloc_moves : pipe_moves;
            PyObject *lst = PyDict_GetItemWithError(moves, job_uid);
            if (lst == NULL) {
                if (PyErr_Occurred())
                    goto fail_inner;
                lst = PyList_New(0);
                if (lst == NULL)
                    goto fail_inner;
                int rc = PyDict_SetItem(moves, job_uid, lst);
                Py_DECREF(lst);  /* dict holds it */
                if (rc < 0)
                    goto fail_inner;
                lst = PyDict_GetItem(moves, job_uid);  /* borrowed */
            }
            if (PyList_Append(lst, task) < 0)
                goto fail_inner;
            if (PyDict_SetItem(touched, job_uid, job) < 0)
                goto fail_inner;
            if (PyList_Append(applied, task) < 0)
                goto fail_inner;
        }
        Py_DECREF(node_tasks);
        Py_DECREF(key);
        Py_DECREF(pod);
        Py_DECREF(job_uid);
        continue;

    fail_inner:
        Py_XDECREF(node_tasks);
        Py_XDECREF(key);
        Py_XDECREF(pod);
        Py_XDECREF(job_uid);
        goto fail;
    }

    Py_DECREF(node_cache);
    return Py_BuildValue("(NNNNN)", applied, skipped, touched,
                         alloc_moves, pipe_moves);

fail:
    Py_XDECREF(node_cache);
    Py_XDECREF(applied);
    Py_XDECREF(skipped);
    Py_XDECREF(touched);
    Py_XDECREF(alloc_moves);
    Py_XDECREF(pipe_moves);
    return NULL;
}

static PyObject *
clone_task_map(PyObject *self, PyObject *args)
{
    /* (tasks: {uid: TaskInfo}) -> (clones: {uid: clone},
     *                              index: {status: {uid: clone}})
     * The per-session snapshot clone walk of JobInfo.snapshot_clone:
     * every job's task map is cloned every cycle (cache.go:627-683 is
     * the reference's equivalent walk). */
    PyObject *src;
    if (!PyArg_ParseTuple(args, "O", &src))
        return NULL;
    if (!PyDict_Check(src)) {
        PyErr_SetString(PyExc_TypeError, "tasks must be a dict");
        return NULL;
    }
    PyObject *clones = PyDict_New();
    PyObject *index = PyDict_New();
    if (clones == NULL || index == NULL)
        goto cfail;
    Py_ssize_t pos = 0;
    PyObject *uid, *task;
    while (PyDict_Next(src, &pos, &uid, &task)) {
        if (layout.type != Py_TYPE(task))
            resolve_layout(Py_TYPE(task));
        PyObject *clone = (layout.valid && Py_TYPE(task) == layout.type)
            ? clone_task_fast(task)
            : PyObject_CallMethodNoArgs(task, s_clone_lite);
        if (clone == NULL)
            goto cfail;
        if (PyDict_SetItem(clones, uid, clone) < 0) {
            Py_DECREF(clone);
            goto cfail;
        }
        PyObject *status = (layout.valid && Py_TYPE(task) == layout.type)
            ? slot_get(clone, SL_STATUS) : NULL;  /* borrowed */
        if (status == NULL) {
            status = PyObject_GetAttrString(clone, "status");
            if (status == NULL) {
                Py_DECREF(clone);
                goto cfail;
            }
            Py_DECREF(status);  /* clone keeps it alive */
        }
        PyObject *bucket = PyDict_GetItemWithError(index, status);
        if (bucket == NULL) {
            if (PyErr_Occurred()) {
                Py_DECREF(clone);
                goto cfail;
            }
            bucket = PyDict_New();
            if (bucket == NULL) {
                Py_DECREF(clone);
                goto cfail;
            }
            int rc = PyDict_SetItem(index, status, bucket);
            Py_DECREF(bucket);
            if (rc < 0) {
                Py_DECREF(clone);
                goto cfail;
            }
            bucket = PyDict_GetItem(index, status);
        }
        int rc = PyDict_SetItem(bucket, uid, clone);
        Py_DECREF(clone);
        if (rc < 0)
            goto cfail;
    }
    return Py_BuildValue("(NN)", clones, index);
cfail:
    Py_XDECREF(clones);
    Py_XDECREF(index);
    return NULL;
}

/* pod_static: the first-touch static-feature derivation of
 * models/tensor_snapshot._pod_static.  The cold first session derives
 * it for EVERY pod (50k calls); the common case — a featureless pod —
 * is a handful of attribute reads ending in an interned result tuple,
 * which is pure C here.  Pods with any static feature (selector,
 * tolerations, affinity, host ports) delegate to the Python body
 * registered via pod_static_setup, which also owns the tuple-building
 * and caching for that branch.  Cache contract is identical: the
 * result is stored on the pod keyed by spec identity. */
static PyObject *ps_empty_sig = NULL, *ps_slow_fn = NULL,
    *ps_empty_tuple = NULL;
static PyObject *s_tensor_static, *s_containers, *s_ports, *s_host_port,
    *s_node_selector, *s_tolerations, *s_affinity;

static PyObject *
pod_static_setup(PyObject *self, PyObject *args)
{
    PyObject *empty_sig, *slow_fn;
    if (!PyArg_ParseTuple(args, "OO", &empty_sig, &slow_fn))
        return NULL;
    Py_XDECREF(ps_empty_sig);
    Py_XDECREF(ps_slow_fn);
    Py_INCREF(empty_sig);
    ps_empty_sig = empty_sig;
    Py_INCREF(slow_fn);
    ps_slow_fn = slow_fn;
    if (ps_empty_tuple == NULL) {
        ps_empty_tuple = PyTuple_New(0);
        if (ps_empty_tuple == NULL)
            return NULL;
    }
    Py_RETURN_NONE;
}

static PyObject *
pod_static(PyObject *self, PyObject *pod)
{
    if (ps_slow_fn == NULL) {
        PyErr_SetString(PyExc_RuntimeError, "pod_static_setup not called");
        return NULL;
    }
    PyObject *spec = PyObject_GetAttr(pod, s_spec);
    if (spec == NULL)
        return NULL;
    PyObject *cached;
    if (LOOKUP_ATTR(pod, s_tensor_static, &cached) < 0) {
        Py_DECREF(spec);
        return NULL;
    }
    if (cached != NULL) {
        if (PyTuple_CheckExact(cached) && PyTuple_GET_SIZE(cached) == 4
            && PyTuple_GET_ITEM(cached, 0) == spec) {
            Py_DECREF(spec);
            return cached;
        }
        Py_DECREF(cached);
    }

    /* Featureless probe; anything unexpected delegates to Python. */
    int featured = 0, delegate = 0;
    PyObject *sel = PyObject_GetAttr(spec, s_node_selector);
    PyObject *tol = sel ? PyObject_GetAttr(spec, s_tolerations) : NULL;
    PyObject *aff = tol ? PyObject_GetAttr(spec, s_affinity) : NULL;
    if (aff == NULL) {
        PyErr_Clear();
        delegate = 1;
    } else {
        int t1 = PyObject_IsTrue(sel);
        int t2 = PyObject_IsTrue(tol);
        if (t1 < 0 || t2 < 0) {
            PyErr_Clear();
            delegate = 1;
        } else {
            featured = t1 || t2 || (aff != Py_None);
        }
    }
    Py_XDECREF(sel);
    Py_XDECREF(tol);
    Py_XDECREF(aff);

    if (!delegate && !featured) {
        PyObject *containers = PyObject_GetAttr(spec, s_containers);
        if (containers == NULL || !PyList_CheckExact(containers)) {
            Py_XDECREF(containers);
            PyErr_Clear();
            delegate = 1;
        } else {
            for (Py_ssize_t i = 0;
                 !featured && !delegate
                     && i < PyList_GET_SIZE(containers); i++) {
                PyObject *ports = PyObject_GetAttr(
                    PyList_GET_ITEM(containers, i), s_ports);
                if (ports == NULL || !PyList_CheckExact(ports)) {
                    Py_XDECREF(ports);
                    PyErr_Clear();
                    delegate = 1;
                    break;
                }
                for (Py_ssize_t k = 0; k < PyList_GET_SIZE(ports); k++) {
                    PyObject *hp = PyObject_GetAttr(
                        PyList_GET_ITEM(ports, k), s_host_port);
                    if (hp == NULL) {
                        PyErr_Clear();
                        delegate = 1;
                        break;
                    }
                    long v = PyLong_AsLong(hp);
                    Py_DECREF(hp);
                    if (v == -1 && PyErr_Occurred()) {
                        PyErr_Clear();
                        delegate = 1;
                        break;
                    }
                    if (v > 0) {
                        featured = 1;
                        break;
                    }
                }
                Py_DECREF(ports);
            }
            Py_DECREF(containers);
        }
    }

    if (delegate || featured) {
        Py_DECREF(spec);
        return PyObject_CallOneArg(ps_slow_fn, pod);
    }

    PyObject *result = PyTuple_Pack(4, spec, Py_False, ps_empty_sig,
                                    ps_empty_tuple);
    Py_DECREF(spec);
    if (result == NULL)
        return NULL;
    if (PyObject_SetAttr(pod, s_tensor_static, result) < 0)
        PyErr_Clear();  /* uncacheable pod: still return the tuple */
    return result;
}

/* assume_walk: pass 1 of the cache's assume mirror
 * (cache/cache.py SchedulerCache._assume_bound_many), the twin of
 * cache/assume.py ``assume_walk_py``, with the same semantics:
 *
 *   assume_walk(jobs, nodes, tasks, hostname, moved, groups, on_nodes,
 *               step_job, placeholder) -> (mirrored, skipped)
 *
 * Per task, in order: skip it when its job or its cached task is gone or
 * the cached task already has a node (the echo landed); else make the
 * bound copy — the cached task's clone with a node-stamped pod, the pod's
 * status and priority, volume_ready False — and move it in its job:
 * fused (out of its status bucket, to the end of job.tasks and its new
 * bucket, appended to moved[job]) or, for a task already allocated or a
 * job without a gang source, through step_job(job, cached, bound).  Then
 * joins groups[hostname] and on_nodes unless it has no node or a
 * terminated status; placeholder(name) makes a node the cache has not
 * seen.  assume_setup registers the types, field names and functions the
 * walk needs, once. */
static PyObject *as_pod_type = NULL, *as_spec_type = NULL,
    *as_pod_fields = NULL, *as_spec_fields = NULL, *as_status_fn = NULL,
    *as_stamp_fn = NULL, *as_no_node = NULL, *as_empty_tuple = NULL,
    *as_one = NULL;
static long as_alloc_mask = 0;
static PyObject *s_pod_group, *s_pdb, *s_task_status_index, *s_priority;

static PyObject *
assume_setup(PyObject *self, PyObject *args)
{
    PyObject *pod_type, *spec_type, *pod_fields, *spec_fields, *status_fn,
        *stamp_fn, *no_node;
    long mask;
    if (!PyArg_ParseTuple(args, "OOOOOOlO", &pod_type, &spec_type,
                          &pod_fields, &spec_fields, &status_fn, &stamp_fn,
                          &mask, &no_node))
        return NULL;
    if (!PyType_Check(pod_type) || !PyType_Check(spec_type)
        || !PyTuple_Check(pod_fields) || !PyTuple_Check(spec_fields)
        || !PyTuple_Check(no_node)) {
        PyErr_SetString(PyExc_TypeError, "assume_setup: bad arguments");
        return NULL;
    }
    PyObject *objs[] = {pod_type, spec_type, pod_fields, spec_fields,
                        status_fn, stamp_fn, no_node};
    PyObject **slots[] = {&as_pod_type, &as_spec_type, &as_pod_fields,
                          &as_spec_fields, &as_status_fn, &as_stamp_fn,
                          &as_no_node};
    for (int i = 0; i < 7; i++) {
        Py_INCREF(objs[i]);
        Py_XSETREF(*slots[i], objs[i]);
    }
    as_alloc_mask = mask;
    if (as_empty_tuple == NULL && (as_empty_tuple = PyTuple_New(0)) == NULL)
        return NULL;
    if (as_one == NULL && (as_one = PyLong_FromLong(1)) == NULL)
        return NULL;
    Py_RETURN_NONE;
}

/* A new instance of ``type`` with ``fields`` copied from ``src`` one by
 * one, as dataclasses.replace shares them: attribute stores keep the
 * instance's inline values, where a __dict__ copy would give both
 * objects a dict for the collector to walk. */
static PyObject *
copy_fields(PyObject *type, PyObject *src, PyObject *fields)
{
    PyObject *obj = PyBaseObject_Type.tp_new((PyTypeObject *)type,
                                             as_empty_tuple, NULL);
    if (obj == NULL)
        return NULL;
    Py_ssize_t n = PyTuple_GET_SIZE(fields);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *name = PyTuple_GET_ITEM(fields, i);
        PyObject *v = PyObject_GetAttr(src, name);
        if (v == NULL || PyObject_SetAttr(obj, name, v) < 0) {
            Py_XDECREF(v);
            Py_DECREF(obj);
            return NULL;
        }
        Py_DECREF(v);
    }
    return obj;
}

/* cache/assume.py node_stamped in C: a new Pod and PodSpec, node_name set,
 * _pod_key carried; other types go to the Python function. */
static PyObject *
stamp_pod(PyObject *pod, PyObject *host)
{
    PyObject *spec = PyObject_GetAttr(pod, s_spec);
    if (spec == NULL)
        return NULL;
    if ((PyObject *)Py_TYPE(pod) != as_pod_type
        || (PyObject *)Py_TYPE(spec) != as_spec_type) {
        Py_DECREF(spec);
        return PyObject_CallFunctionObjArgs(as_stamp_fn, pod, host, NULL);
    }
    PyObject *new_spec = copy_fields(as_spec_type, spec, as_spec_fields);
    Py_DECREF(spec);
    if (new_spec == NULL)
        return NULL;
    if (PyObject_SetAttr(new_spec, s_node_name, host) < 0) {
        Py_DECREF(new_spec);
        return NULL;
    }
    PyObject *new_pod = copy_fields(as_pod_type, pod, as_pod_fields);
    if (new_pod == NULL || PyObject_SetAttr(new_pod, s_spec, new_spec) < 0) {
        Py_XDECREF(new_pod);
        Py_DECREF(new_spec);
        return NULL;
    }
    Py_DECREF(new_spec);
    PyObject *key;
    if (LOOKUP_ATTR(pod, s_pod_key_cache, &key) < 0) {
        Py_DECREF(new_pod);
        return NULL;
    }
    if (key != NULL) {
        int rc = PyObject_SetAttr(new_pod, s_pod_key_cache, key);
        Py_DECREF(key);
        if (rc < 0) {
            Py_DECREF(new_pod);
            return NULL;
        }
    }
    return new_pod;
}

static inline void
slot_put(PyObject *obj, int slot, PyObject *v)  /* takes a new ref */
{
    PyObject **p = (PyObject **)((char *)obj + layout.offsets[slot]);
    PyObject *old = *p;
    *p = v;
    Py_XDECREF(old);
}

/* The bound copy of ``cached`` on ``host``; *status_out borrows its
 * status.  Needs the fast layout (checked by the caller). */
static PyObject *
bound_copy(PyObject *cached, PyObject *host, PyObject **status_out)
{
    PyObject *pod = stamp_pod(slot_get(cached, SL_POD), host);
    if (pod == NULL)
        return NULL;
    PyObject *status = PyObject_CallOneArg(as_status_fn, pod);
    if (status == NULL) {
        Py_DECREF(pod);
        return NULL;
    }
    PyObject *spec = PyObject_GetAttr(pod, s_spec);
    PyObject *priority = spec ? PyObject_GetAttr(spec, s_priority) : NULL;
    Py_XDECREF(spec);
    if (priority == NULL) {
        Py_DECREF(status);
        Py_DECREF(pod);
        return NULL;
    }
    if (priority == Py_None) {
        Py_DECREF(priority);
        priority = Py_NewRef(as_one);
    }
    PyObject *bound = clone_task_fast(cached);
    if (bound == NULL) {
        Py_DECREF(priority);
        Py_DECREF(status);
        Py_DECREF(pod);
        return NULL;
    }
    slot_put(bound, SL_POD, pod);
    slot_put(bound, SL_NODE_NAME, Py_NewRef(host));
    slot_put(bound, SL_STATUS, status);
    slot_put(bound, SL_PRIORITY, priority);
    slot_put(bound, SL_VOLUME_READY, Py_NewRef(Py_False));
    *status_out = status;
    return bound;
}

/* list at d[key], made empty when missing; borrowed. */
static PyObject *
list_at(PyObject *d, PyObject *key)
{
    PyObject *lst = PyDict_GetItemWithError(d, key);
    if (lst != NULL || PyErr_Occurred())
        return lst;
    lst = PyList_New(0);
    if (lst == NULL)
        return NULL;
    int rc = PyDict_SetItem(d, key, lst);
    Py_DECREF(lst);
    return rc < 0 ? NULL : lst;
}

/* The fused job move of cached -> bound (see the walk's comment). */
static int
fused_move(PyObject *job, PyObject *job_tasks, PyObject *cached,
           PyObject *bound, PyObject *status, PyObject *moved)
{
    PyObject *uid = slot_get(cached, SL_UID);
    PyObject *old_status = slot_get(cached, SL_STATUS);
    PyObject *index = PyObject_GetAttr(job, s_task_status_index);
    if (index == NULL)
        return -1;
    int rc = -1;
    PyObject *bucket = PyDict_GetItemWithError(index, old_status);
    if (bucket == NULL && PyErr_Occurred())
        goto done;
    if (bucket != NULL) {
        int has = PyDict_Contains(bucket, uid);
        if (has < 0 || (has && PyDict_DelItem(bucket, uid) < 0))
            goto done;
        if (PyDict_GET_SIZE(bucket) == 0
            && PyDict_DelItem(index, old_status) < 0)
            goto done;
    }
    if (PyDict_DelItem(job_tasks, uid) < 0
        || PyDict_SetItem(job_tasks, uid, bound) < 0)
        goto done;
    /* index[status]: the defaultdict makes the bucket when missing. */
    PyObject *dest = PyObject_GetItem(index, status);
    if (dest == NULL)
        goto done;
    int set = PyDict_Check(dest) ? PyDict_SetItem(dest, uid, bound)
                                 : PyObject_SetItem(dest, uid, bound);
    Py_DECREF(dest);
    if (set < 0)
        goto done;
    PyObject *fused = list_at(moved, job);
    if (fused == NULL || PyList_Append(fused, bound) < 0)
        goto done;
    rc = 0;
done:
    Py_DECREF(index);
    return rc;
}

/* Whether the job side of cached must take the exact steps: its job has
 * neither a pod group nor a PDB, or the task is already allocated. */
static int
needs_exact(PyObject *job, PyObject *cached)
{
    PyObject *pg = PyObject_GetAttr(job, s_pod_group);
    if (pg == NULL)
        return -1;
    int none = (pg == Py_None);
    Py_DECREF(pg);
    if (none) {
        PyObject *pdb = PyObject_GetAttr(job, s_pdb);
        if (pdb == NULL)
            return -1;
        none = (pdb == Py_None);
        Py_DECREF(pdb);
        if (none)
            return 1;
    }
    long st = PyLong_AsLong(slot_get(cached, SL_STATUS));
    if (st == -1 && PyErr_Occurred())
        return -1;
    return (st & as_alloc_mask) != 0;
}

static PyObject *
assume_walk(PyObject *self, PyObject *args)
{
    PyObject *jobs, *nodes, *tasks, *hostname, *moved, *groups, *on_nodes,
        *step_job, *placeholder;
    if (!PyArg_ParseTuple(args, "OOOOOOOOO", &jobs, &nodes, &tasks,
                          &hostname, &moved, &groups, &on_nodes, &step_job,
                          &placeholder))
        return NULL;
    if (as_status_fn == NULL) {
        PyErr_SetString(PyExc_RuntimeError, "assume_setup not called");
        return NULL;
    }
    if (!PyDict_Check(jobs) || !PyDict_Check(nodes) || !PyDict_Check(moved)
        || !PyDict_Check(groups) || !PyList_Check(on_nodes)) {
        PyErr_SetString(PyExc_TypeError, "assume_walk: bad arguments");
        return NULL;
    }
    PyObject *seq = PySequence_Fast(tasks, "tasks must be a sequence");
    if (seq == NULL)
        return NULL;
    Py_ssize_t mirrored = 0, skipped = 0;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *t = PySequence_Fast_GET_ITEM(seq, i);
        PyObject *job_uid = PyObject_GetAttr(t, s_job);
        if (job_uid == NULL)
            goto fail;
        PyObject *job = PyDict_GetItemWithError(jobs, job_uid);
        Py_DECREF(job_uid);
        if (job == NULL) {
            if (PyErr_Occurred())
                goto fail;
            skipped++;
            continue;
        }
        Py_INCREF(job);
        PyObject *uid = PyObject_GetAttr(t, s_uid);
        PyObject *job_tasks = uid ? PyObject_GetAttr(job, s_tasks) : NULL;
        PyObject *cached = job_tasks
            ? PyDict_GetItemWithError(job_tasks, uid) : NULL;
        Py_XDECREF(uid);
        if (cached == NULL) {
            Py_XDECREF(job_tasks);
            Py_DECREF(job);
            if (PyErr_Occurred())
                goto fail;
            skipped++;
            continue;
        }
        Py_INCREF(cached);  /* job.tasks lets go of it below */
        PyObject *host = NULL, *bound = NULL, *status = NULL;
        if (layout.type != Py_TYPE(cached))
            resolve_layout(Py_TYPE(cached));
        if (!layout.valid || Py_TYPE(cached) != layout.type
            || slot_get(cached, SL_NODE_NAME) == NULL
            || slot_get(cached, SL_POD) == NULL) {
            PyErr_SetString(PyExc_TypeError,
                            "assume_walk: unexpected task layout");
            goto fail_task;
        }
        int landed = PyObject_IsTrue(slot_get(cached, SL_NODE_NAME));
        if (landed < 0)
            goto fail_task;
        if (landed) {
            Py_DECREF(cached);
            Py_DECREF(job_tasks);
            Py_DECREF(job);
            skipped++;
            continue;
        }
        mirrored++;
        host = hostname == Py_None ? PyObject_GetAttr(t, s_node_name)
                                   : Py_NewRef(hostname);
        if (host == NULL)
            goto fail_task;
        bound = bound_copy(cached, host, &status);
        if (bound == NULL)
            goto fail_task;
        int ex = needs_exact(job, cached);
        if (ex < 0)
            goto fail_task;
        if (ex) {
            PyObject *r = PyObject_CallFunctionObjArgs(step_job, job, cached,
                                                       bound, NULL);
            if (r == NULL)
                goto fail_task;
            Py_DECREF(r);
        } else if (fused_move(job, job_tasks, cached, bound, status,
                              moved) < 0) {
            goto fail_task;
        }
        int keep = PyObject_IsTrue(host);
        if (keep < 0)
            goto fail_task;
        if (keep) {
            int term = PySequence_Contains(as_no_node, status);
            if (term < 0)
                goto fail_task;
            keep = !term;
        }
        if (keep) {
            PyObject *group = PyDict_GetItemWithError(groups, host);
            if (group == NULL) {
                if (PyErr_Occurred())
                    goto fail_task;
                int known = PyDict_Contains(nodes, host);
                if (known < 0)
                    goto fail_task;
                if (!known) {
                    PyObject *r = PyObject_CallOneArg(placeholder, host);
                    if (r == NULL)
                        goto fail_task;
                    Py_DECREF(r);
                }
                group = list_at(groups, host);
                if (group == NULL)
                    goto fail_task;
            }
            if (PyList_Append(group, bound) < 0
                || PyList_Append(on_nodes, bound) < 0)
                goto fail_task;
        }
        Py_DECREF(bound);
        Py_DECREF(host);
        Py_DECREF(cached);
        Py_DECREF(job_tasks);
        Py_DECREF(job);
        continue;
    fail_task:
        Py_XDECREF(bound);
        Py_XDECREF(host);
        Py_DECREF(cached);
        Py_DECREF(job_tasks);
        Py_DECREF(job);
        goto fail;
    }
    Py_DECREF(seq);
    return Py_BuildValue("(nn)", mirrored, skipped);
fail:
    Py_DECREF(seq);
    return NULL;
}

/* assume_group(node_tasks, group, releasing) -> sums | False | None
 *
 * The common case of cache/assume.py group_sums, for one node's new tasks
 * in the assume mirror: (cpu, memory, Releasing cpu, Releasing memory,
 * Releasing count), each summed in group order from 0.0; False where a
 * pod key is already in node_tasks or repeats in the group, or a
 * request's milli-CPU or memory is negative or not a whole number (the
 * Python form refuses those too); None where a request has scalar
 * resources or a layout this does not read, and the Python form
 * decides. */
static PyObject *s_milli_cpu, *s_memory, *s_scalar_resources;

/* 1 and *out set where obj is a float that is whole and not negative;
 * 0 where it is a float that is not; -1 (no error set) for another
 * type. */
static int
whole_float(PyObject *obj, double *out)
{
    if (!PyFloat_CheckExact(obj))
        return -1;
    double v = PyFloat_AS_DOUBLE(obj);
    if (!(v >= 0.0 && isfinite(v) && v == floor(v)))
        return 0;
    *out = v;
    return 1;
}

static PyObject *
assume_group(PyObject *self, PyObject *args)
{
    PyObject *node_tasks, *group, *releasing;
    if (!PyArg_ParseTuple(args, "OOO", &node_tasks, &group, &releasing))
        return NULL;
    if (!PyDict_Check(node_tasks) || !PyList_Check(group))
        Py_RETURN_NONE;
    Py_ssize_t n = PyList_GET_SIZE(group);
    PyObject *seen = n > 1 ? PySet_New(NULL) : NULL;
    if (n > 1 && seen == NULL)
        return NULL;
    PyObject *result = NULL;
    double cpu = 0.0, mem = 0.0, rel_cpu = 0.0, rel_mem = 0.0;
    Py_ssize_t n_rel = 0;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *t = PyList_GET_ITEM(group, i);
        if (layout.type != Py_TYPE(t))
            resolve_layout(Py_TYPE(t));
        if (!layout.valid || Py_TYPE(t) != layout.type
            || slot_get(t, SL_POD) == NULL || slot_get(t, SL_RESREQ) == NULL
            || slot_get(t, SL_STATUS) == NULL) {
            result = Py_NewRef(Py_None);
            goto done;
        }
        PyObject *key = get_pod_key(slot_get(t, SL_POD));
        if (key == NULL)
            goto done;
        int dup = PyDict_Contains(node_tasks, key);
        if (dup == 0 && seen != NULL) {
            dup = PySet_Contains(seen, key);
            if (dup == 0 && PySet_Add(seen, key) < 0)
                dup = -1;
        }
        Py_DECREF(key);
        if (dup < 0)
            goto done;
        if (dup) {
            result = Py_NewRef(Py_False);
            goto done;
        }
        PyObject *r = slot_get(t, SL_RESREQ);
        PyObject *sc = PyObject_GetAttr(r, s_scalar_resources);
        if (sc == NULL)
            goto done;
        int plain = PyDict_Check(sc) && PyDict_GET_SIZE(sc) == 0;
        Py_DECREF(sc);
        if (!plain) {
            result = Py_NewRef(Py_None);
            goto done;
        }
        PyObject *c_obj = PyObject_GetAttr(r, s_milli_cpu);
        PyObject *m_obj = c_obj ? PyObject_GetAttr(r, s_memory) : NULL;
        if (m_obj == NULL) {
            Py_XDECREF(c_obj);
            goto done;
        }
        double c = 0.0, m = 0.0;
        int wc = whole_float(c_obj, &c), wm = whole_float(m_obj, &m);
        Py_DECREF(c_obj);
        Py_DECREF(m_obj);
        if (wc < 0 || wm < 0) {
            result = Py_NewRef(Py_None);
            goto done;
        }
        if (!wc || !wm) {
            result = Py_NewRef(Py_False);
            goto done;
        }
        cpu += c;
        mem += m;
        int rel = PyObject_RichCompareBool(slot_get(t, SL_STATUS), releasing,
                                           Py_EQ);
        if (rel < 0)
            goto done;
        if (rel) {
            rel_cpu += c;
            rel_mem += m;
            n_rel++;
        }
    }
    result = Py_BuildValue("(ddddn)", cpu, mem, rel_cpu, rel_mem, n_rel);
done:
    Py_XDECREF(seen);
    return result;
}

/* assume_insert(node_tasks, group): node_tasks[pod key] = the task's
 * clone, for each task of group in order (cache/assume.py insert_clones). */
static PyObject *
assume_insert(PyObject *self, PyObject *args)
{
    PyObject *node_tasks, *group;
    if (!PyArg_ParseTuple(args, "OO", &node_tasks, &group))
        return NULL;
    PyObject *seq = PySequence_Fast(group, "group must be a sequence");
    if (seq == NULL)
        return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *t = PySequence_Fast_GET_ITEM(seq, i);
        if (layout.type != Py_TYPE(t))
            resolve_layout(Py_TYPE(t));
        int fast = layout.valid && Py_TYPE(t) == layout.type;
        PyObject *pod = fast ? slot_get(t, SL_POD) : NULL;
        pod = pod ? Py_NewRef(pod) : PyObject_GetAttr(t, s_pod);
        PyObject *key = pod ? get_pod_key(pod) : NULL;
        Py_XDECREF(pod);
        PyObject *clone = key == NULL ? NULL
            : fast ? clone_task_fast(t)
                   : PyObject_CallMethodNoArgs(t, s_clone_lite);
        int rc = clone ? PyObject_SetItem(node_tasks, key, clone) : -1;
        Py_XDECREF(clone);
        Py_XDECREF(key);
        if (rc < 0) {
            Py_DECREF(seq);
            return NULL;
        }
    }
    Py_DECREF(seq);
    Py_RETURN_NONE;
}

static PyMethodDef methods[] = {
    {"apply_placements", apply_placements, METH_VARARGS,
     "Pass 1 of Session.batch_apply (see module docstring)."},
    {"clone_task_map", clone_task_map, METH_VARARGS,
     "Clone a job's {uid: TaskInfo} map plus its status index."},
    {"pod_static_setup", pod_static_setup, METH_VARARGS,
     "Register (empty_sig, slow_fn) for pod_static."},
    {"pod_static", pod_static, METH_O,
     "First-touch static-feature derivation for a pod (cached)."},
    {"assume_setup", assume_setup, METH_VARARGS,
     "Register the types, fields and functions of assume_walk."},
    {"assume_walk", assume_walk, METH_VARARGS,
     "Pass 1 of the cache's assume mirror (see its comment)."},
    {"assume_group", assume_group, METH_VARARGS,
     "One node's sums for the assume mirror (see its comment)."},
    {"assume_insert", assume_insert, METH_VARARGS,
     "Insert a node's new tasks' clones for the assume mirror."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_fastpath_torch",
    "Native host-loop kernels for kube_batch_tpu_torch.", -1, methods,
};

PyMODINIT_FUNC
PyInit__fastpath_torch(void)
{
    s_job = PyUnicode_InternFromString("job");
    s_pod = PyUnicode_InternFromString("pod");
    s_spec = PyUnicode_InternFromString("spec");
    s_volumes = PyUnicode_InternFromString("volumes");
    s_node_name = PyUnicode_InternFromString("node_name");
    s_name = PyUnicode_InternFromString("name");
    s_tasks = PyUnicode_InternFromString("tasks");
    s_clone_lite = PyUnicode_InternFromString("clone_lite");
    s_pod_key_cache = PyUnicode_InternFromString("_pod_key");
    s_metadata = PyUnicode_InternFromString("metadata");
    s_namespace = PyUnicode_InternFromString("namespace");
    s_lazy = PyUnicode_InternFromString("_lazy");
    s_status = PyUnicode_InternFromString("status");
    s_tensor_static = PyUnicode_InternFromString("_tensor_static");
    s_containers = PyUnicode_InternFromString("containers");
    s_ports = PyUnicode_InternFromString("ports");
    s_host_port = PyUnicode_InternFromString("host_port");
    s_node_selector = PyUnicode_InternFromString("node_selector");
    s_tolerations = PyUnicode_InternFromString("tolerations");
    s_affinity = PyUnicode_InternFromString("affinity");
    s_uid = PyUnicode_InternFromString("uid");
    s_pod_group = PyUnicode_InternFromString("pod_group");
    s_pdb = PyUnicode_InternFromString("pdb");
    s_task_status_index = PyUnicode_InternFromString("task_status_index");
    s_priority = PyUnicode_InternFromString("priority");
    s_milli_cpu = PyUnicode_InternFromString("milli_cpu");
    s_memory = PyUnicode_InternFromString("memory");
    s_scalar_resources = PyUnicode_InternFromString("scalar_resources");
    if (!s_job || !s_pod || !s_spec || !s_volumes || !s_node_name
        || !s_name || !s_tasks || !s_clone_lite || !s_pod_key_cache
        || !s_metadata || !s_namespace || !s_lazy || !s_status
        || !s_tensor_static
        || !s_containers || !s_ports || !s_host_port || !s_node_selector
        || !s_tolerations || !s_affinity || !s_uid || !s_pod_group
        || !s_pdb || !s_task_status_index || !s_priority || !s_milli_cpu
        || !s_memory || !s_scalar_resources)
        return NULL;
    return PyModule_Create(&moduledef);
}
