"""One module a traffic driver: ``run(run) → Outcome``."""
