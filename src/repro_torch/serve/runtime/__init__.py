"""Serving runtime: slots, scheduler, workload adapters."""
