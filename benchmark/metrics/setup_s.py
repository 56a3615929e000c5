"""setup_s: seconds from the process's start to the window's opening
(imports, kernel builds or the build cache, inputs, the program's set-up,
the compared first steps and the warm-up), on the host's clock."""


def read(record):
    return record.get("setup_s")
