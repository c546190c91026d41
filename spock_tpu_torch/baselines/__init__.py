"""Reference solvers outside the port's own iteration: the float64 native C++
oracle (:mod:`.native`)."""
