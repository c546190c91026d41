"""Reference solvers outside the port's own iteration: the float64 native C++
oracle (:mod:`.native`), the dense SLSQP oracle (:mod:`.scipy_ref`, also
EVaR's) and the sparse conic ADMM oracle (:mod:`.admm_ref`)."""
