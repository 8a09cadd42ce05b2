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
 * deferred status-index moves.  Behavior is bit-identical to the Python
 * loop it replaces; kube_batch_tpu_torch/native/__init__.py falls back to
 * that loop when this extension cannot be built.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <structmember.h>

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
    *s_namespace, *s_lazy, *s_status;

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

static PyMethodDef methods[] = {
    {"apply_placements", apply_placements, METH_VARARGS,
     "Pass 1 of Session.batch_apply (see module docstring)."},
    {"clone_task_map", clone_task_map, METH_VARARGS,
     "Clone a job's {uid: TaskInfo} map plus its status index."},
    {"pod_static_setup", pod_static_setup, METH_VARARGS,
     "Register (empty_sig, slow_fn) for pod_static."},
    {"pod_static", pod_static, METH_O,
     "First-touch static-feature derivation for a pod (cached)."},
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
    if (!s_job || !s_pod || !s_spec || !s_volumes || !s_node_name
        || !s_name || !s_tasks || !s_clone_lite || !s_pod_key_cache
        || !s_metadata || !s_namespace || !s_lazy || !s_status
        || !s_tensor_static
        || !s_containers || !s_ports || !s_host_port || !s_node_selector
        || !s_tolerations || !s_affinity)
        return NULL;
    return PyModule_Create(&moduledef);
}
