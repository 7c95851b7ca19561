"""Resilience seams of the port: the clock, counters, the lock-order
sanitizer, the preemption guard and seeded chaos injection."""
