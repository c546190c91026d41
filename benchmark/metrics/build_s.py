"""Seconds of the offline build (problem.build), host clock around it."""


def read(run):
    return run["build_s"]
