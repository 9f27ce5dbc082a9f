"""The plain reference: a path tracer in plain torch and numpy that
imports nothing of the program and takes nothing the program made
(tracer.py, scene.py, and frozen copies of the program's plain math
beside them), and the comparison that decides a run's `correct`
(check.py)."""
