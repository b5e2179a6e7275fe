"""Clean fixture: the battery's family names (covers 'dense' only, so
families_bad's 'ghost' drifts)."""

SERVED = {"dense": "smollm-135m"}
