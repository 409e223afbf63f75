"""Run-time policies of a multi-process job: failure injection, restart policy, straggler watchdog."""
