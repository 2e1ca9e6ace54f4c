"""S-HPLB host planning: sparsity profiles, max-min budgets, head
partitioning, the deployment planner and the work-list encodings (numpy
only, copied from the reference package)."""
