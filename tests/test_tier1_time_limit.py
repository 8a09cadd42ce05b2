"""The per-case time limit of the repo's root conftest.py, as the tier-1
suite runs it (xdist, ``--dist loadfile``), in a subprocess on temporary
test files with the limit cut to a few seconds.

``test_a_hangs.py``'s first case hangs in a sleep, in two threads.  At
the limit its worker dumps every thread's stack and ends; xdist reports
the case as failed and hands the rest of its file, the hung case
included, to the other worker, which the other files keep busy, and not
yet shutting down, at that moment.  The hung case is not run again; the
rest of its file runs there and passes."""

import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 3
SLEEP_S = 600

HEAD = '''
import os
import threading
import time

import conftest

conftest.CASE_LIMIT_S = {limit}
STARTED = {started!r}


def hang_began():
    """When test_a1_hangs began, once it has."""
    while not os.path.exists(STARTED):
        time.sleep(0.05)
    with open(STARTED) as f:
        return float(f.read())


def sleep_until(moment):
    time.sleep(max(0.0, moment - time.time()))
'''

FILES = {
    "test_a_hangs.py": f'''
def sleep_past_the_limit():
    time.sleep({SLEEP_S})


def test_a1_hangs():
    with open(STARTED + ".part", "w") as f:
        f.write(repr(time.time()))
    os.rename(STARTED + ".part", STARTED)
    threading.Thread(target=sleep_past_the_limit, daemon=True).start()
    sleep_past_the_limit()


def test_a2_passes():
    pass


def test_a3_passes():
    pass
''',
    # The other worker takes b, then c, then d while the queue still
    # holds one, and is inside d when the hang reaches the limit.
    "test_b_waits.py": '''
def test_b1_waits_for_the_hang():
    hang_began()
''',
    "test_c_waits.py": f'''
def test_c1_waits_half_the_limit():
    sleep_until(hang_began() + {LIMIT_S} / 2)
''',
    "test_d_waits.py": f'''
def test_d1_waits_past_the_crash():
    sleep_until(hang_began() + {LIMIT_S} + 1)
''',
    "test_e_passes.py": '''
def test_e1_passes():
    pass
''',
}


def test_a_case_past_its_limit_fails_alone_once(tmp_path):
    head = HEAD.format(limit=LIMIT_S, started=str(tmp_path / "started"))
    for name, body in FILES.items():
        (tmp_path / name).write_text(head + body)
    t0 = time.monotonic()
    run = subprocess.run(
        [sys.executable, "-m", "pytest", str(tmp_path), "-p", "conftest",
         "-p", "xdist", "-n", "2", "--dist", "loadfile", "-p",
         "no:cacheprovider", "-p", "no:randomly", "--rootdir",
         str(tmp_path), "-rA", "-v"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO))
    wall = time.monotonic() - t0
    out = run.stdout + run.stderr
    assert run.returncode == 1, out
    outcomes = sorted(line.split(" ")[:2] for line in out.splitlines()
                      if line.startswith(("FAILED ", "PASSED ", "ERROR ")))
    assert outcomes == [
        ["FAILED", "test_a_hangs.py::test_a1_hangs"],
        ["PASSED", "test_a_hangs.py::test_a2_passes"],
        ["PASSED", "test_a_hangs.py::test_a3_passes"],
        ["PASSED", "test_b_waits.py::test_b1_waits_for_the_hang"],
        ["PASSED", "test_c_waits.py::test_c1_waits_half_the_limit"],
        ["PASSED", "test_d_waits.py::test_d1_waits_past_the_crash"],
        ["PASSED", "test_e_passes.py::test_e1_passes"]], out
    assert out.count("crashed while running "
                     "'test_a_hangs.py::test_a1_hangs'") == 1, out
    assert out.count(f"Timeout (0:00:0{LIMIT_S})!") == 1, out
    assert out.count("in sleep_past_the_limit") == 2, out
    assert "in test_a1_hangs" in out, out
    assert "1 failed, 6 passed" in out, out
    ran_on = {case: gw for gw, case in
              re.findall(r"\[(gw\d+)\] \[ *\d+%\] \w+ \S+::(\w+)", out)}
    assert ran_on["test_a1_hangs"] != ran_on["test_a2_passes"], out
    assert (ran_on["test_a2_passes"] == ran_on["test_a3_passes"]
            == ran_on["test_d1_waits_past_the_crash"]), out
    assert wall < 60, out
