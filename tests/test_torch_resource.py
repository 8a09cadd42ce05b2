"""The port's resource algebra against the JAX package's: the twin of
tests/test_resource.py.  Each body runs once per package (``twin``) on the
package's own ``api`` objects; the results must be equal, and equal to
what the reference's tests expect."""

import pytest

from tests.test_torch_utils import twin


def rv(r):
    """A resource as plain values."""
    return (r.milli_cpu, r.memory, dict(r.scalar_resources or {}),
            r.max_task_num)


def res(p, cpu=0.0, mem=0.0, **scalars):
    return p.m.api.Resource(milli_cpu=cpu, memory=mem,
                            scalar_resources=scalars)


def raises(fn, exc):
    try:
        fn()
    except exc as e:
        return type(e).__name__
    return None


class TestParseQuantity:
    def test_plain(self):
        cases = (2, "2", "250m", "1Gi", "1G", "512Ki")
        got = twin(lambda p: [p.m.api.parse_quantity(c) for c in cases])
        assert got == [2.0, 2.0, 0.25, 1024 ** 3, 1e9, 512 * 1024]

    def test_invalid(self):
        got = twin(lambda p: [raises(lambda: p.m.api.parse_quantity(c),
                                     ValueError) for c in ("abc", "1Qx")])
        assert got == ["ValueError"] * 2

    def test_full_grammar(self):
        cases = ("1e3", "12E2", "1e-3", "1E", "100n", "5u", "-1", "+2.5Gi",
                 ".5")
        got = twin(lambda p: [p.m.api.parse_quantity(c) for c in cases])
        assert got[:4] == [1000.0, 1200.0, 0.001, 1e18]
        assert got[4] == pytest.approx(1e-7)
        assert got[5] == pytest.approx(5e-6)
        assert got[6:] == [-1.0, 2.5 * 1024 ** 3, 0.5]


class TestFromResourceList:
    def test_units(self):
        got = twin(lambda p: rv(p.m.api.Resource.from_resource_list(
            {"cpu": "2", "memory": "1Gi", "pods": 110,
             "nvidia.com/gpu": 1})))
        assert got == (2000.0, 1024 ** 3, {"nvidia.com/gpu": 1000.0}, 110)

    def test_milli_cpu(self):
        got = twin(lambda p: rv(p.m.api.Resource.from_resource_list(
            {"cpu": "250m", "memory": "100Mi"})))
        assert got[0] == 250.0

    def test_scalar_name_filter(self):
        got = twin(lambda p: sorted(p.m.api.Resource.from_resource_list(
            {"cpu": "1", "memory": "1Gi", "ephemeral-storage": "10Gi",
             "requests.example.com/gpu": 1, "hugepages-2Mi": "4Mi",
             "example.com/fpga": 2, "kubernetes.io/batteries": 1,
             "attachable-volumes-aws-ebs": 39}).scalar_resources))
        assert got == sorted({"hugepages-2Mi", "example.com/fpga",
                              "kubernetes.io/batteries",
                              "attachable-volumes-aws-ebs"})


class TestArithmetic:
    @pytest.mark.parametrize("left,right,expected", [
        ((1000, 100, {}), (2000, 1000, {}), (3000, 1100, {})),
        ((1000, 100, {"gpu": 1}), (2000, 1000, {"gpu": 2}),
         (3000, 1100, {"gpu": 3})),
        ((0, 0, {}), (2000, 1000, {}), (2000, 1000, {})),
    ])
    def test_add(self, left, right, expected):
        def body(p):
            total = res(p, left[0], left[1], **left[2]).add(
                res(p, right[0], right[1], **right[2]))
            return (rv(total),
                    total == res(p, expected[0], expected[1], **expected[2]))
        assert twin(body)[1]

    def test_sub(self):
        def body(p):
            a = res(p, 3000, 1100).sub(res(p, 1000, 100))
            b = res(p, 3000, 1100, g=3000).sub(res(p, 1000, 100, g=1000))
            return rv(a), rv(b)
        assert twin(body) == ((2000, 1000, {}, 0),
                              (2000, 1000, {"g": 2000}, 0))

    def test_sub_insufficient_raises(self):
        assert twin(lambda p: raises(
            lambda: res(p, 1000, 100).sub(res(p, 2000, 100)),
            ValueError)) == "ValueError"

    def test_sub_within_epsilon_ok(self):
        assert twin(lambda p: res(p, 1000, 100).sub(
            res(p, 1005, 100)).milli_cpu) == -5.0

    def test_multi(self):
        assert twin(lambda p: rv(res(p, 1000, 100, g=2000).multi(2))) == \
            (2000, 200, {"g": 4000}, 0)

    def test_set_max_resource(self):
        def body(p):
            r = res(p, 1000, 2000, g=1000)
            r.set_max_resource(res(p, 2000, 100, h=5))
            return rv(r)
        assert twin(body) == (2000, 2000, {"g": 1000, "h": 5}, 0)

    def test_fit_delta(self):
        def body(p):
            r = res(p, 1000, 20 * 1024 * 1024)
            r.fit_delta(res(p, 500, 10 * 1024 * 1024))
            return rv(r)
        got = twin(body)
        assert got[0] == 1000 - 500 - 10 and got[1] == 0.0

    def test_clone_independent(self):
        def body(p):
            r = res(p, 1, 2, g=3)
            c = r.clone()
            c.add(res(p, 1, 1, g=1))
            return rv(r), rv(c)
        assert twin(body) == ((1, 2, {"g": 3}, 0), (2, 3, {"g": 4}, 0))


class TestComparisons:
    def test_is_empty(self):
        cases = ((0, 0, {}), (9.99, 0, {}), (0, 10 * 1024 * 1024 - 1, {}),
                 (10, 0, {}), (0, 10 * 1024 * 1024, {}), (0, 0, {"g": 10}),
                 (0, 0, {"g": 9.9}))
        got = twin(lambda p: [res(p, c, m, **s).is_empty()
                              for c, m, s in cases])
        assert got == [True, True, True, False, False, False, True]

    def test_is_zero(self):
        def body(p):
            r = res(p, 5, 5, g=5)
            return ([r.is_zero(n) for n in ("cpu", "memory", "g")],
                    raises(lambda: r.is_zero("unknown"), KeyError))
        assert twin(body) == ([True, True, True], "KeyError")

    def test_less(self):
        cases = (((100, 100, {}), (200, 200, {})),
                 ((100, 100, {}), (100, 200, {})),
                 ((100, 300, {}), (200, 200, {})),
                 ((100, 100, {}), (200, 200, {"g": 100})),
                 ((100, 100, {}), (200, 200, {"g": 10})),
                 ((100, 100, {"g": 1}), (200, 200, {})))
        got = twin(lambda p: [res(p, a[0], a[1], **a[2]).less(
            res(p, b[0], b[1], **b[2])) for a, b in cases])
        assert got == [True, False, False, True, False, False]

    def test_less_equal(self):
        cases = (((100, 100, {}), (100, 100, {})),
                 ((105, 100, {}), (100, 100, {})),
                 ((111, 100, {}), (100, 100, {})),
                 ((0, 0, {"g": 9}), (0, 0, {})),
                 ((0, 0, {"g": 100}), (0, 0, {})),
                 ((0, 0, {"g": 100}), (0, 0, {"g": 105})))
        got = twin(lambda p: [res(p, a[0], a[1], **a[2]).less_equal(
            res(p, b[0], b[1], **b[2])) for a, b in cases])
        assert got == [True, True, False, True, False, True]

    def test_diff(self):
        def body(p):
            inc, dec = res(p, 300, 100, g=10).diff(res(p, 100, 300, g=10))
            return rv(inc), rv(dec)
        inc, dec = twin(body)
        assert inc[:2] == (200, 0) and dec[:2] == (0, 200)


class TestHelpers:
    def test_minimum(self):
        def body(p):
            a = p.m.api.minimum(res(p, 100, 200), res(p, 200, 100))
            b = p.m.api.minimum(res(p, 100, 200, g=5), res(p, 200, 100, g=3))
            return rv(a), rv(b)
        a, b = twin(body)
        assert a[:2] == (100, 100) and b[2]["g"] == 3

    def test_share(self):
        assert twin(lambda p: [p.m.api.share(a, b) for a, b in
                               ((0, 0), (5, 0), (5, 10))]) == [0.0, 1.0, 0.5]
