"""Plain references of the configurations, one module a configuration
(``reference/<config>.py``), found by name. They import nothing of the
program: each rebuilds its configuration's state from the inputs the
harness handed to the program and judges the program's output."""
