"""The benchmark's own code: finding a cell's files by name (`spec`), the
timed window (`window`), the profiler trace and its reduction (`trace`),
the comparison with the reference (`checks`), the ranks of a multi-card
cell (`ranks`), and the frozen copies of the repo's measuring pieces
(`opcount`, `roofline`)."""
