# %% [markdown]
# # Progress bars
#
# Tutorial counterpart of the reference's `progress_bars.ipynb`: the text
# progress bar styles, the file-sink mode (for cluster jobs whose stdout
# you can't watch), and the two distributed servers — multiprocess
# (shared-memory transport) and ZMQ (cross-host sockets) — that aggregate
# many workers into one bar. The Monte Carlo runner picks these up
# automatically through `update_progress_function_style`.
#
# Runs as a script or as percent-format notebook cells.

# %%
import io
import sys
import time

from pyphysim_tpu.progressbar import (ProgressbarText, ProgressbarText2,
                                      ProgressbarText3)

# %% [markdown]
# ## Text styles
#
# Style 1 is the classic bar with a centered message, style 2 a bar with
# percentage and elapsed time, style 3 a count display.

# %%
for cls in (ProgressbarText, ProgressbarText2, ProgressbarText3):
    out = io.StringIO()
    bar = cls(50, message="demo", output=out)
    for i in (10, 30, 50):
        bar.progress(i)
    text = out.getvalue().replace("\r", "\n").strip().splitlines()[-1]
    print(f"{cls.__name__:18s}: {text}")

# %% [markdown]
# ## File sink
#
# Writing progress to a file lets a detached job report status; the
# Monte Carlo runner's `progress_output_type='file'` uses this to write
# `<name>_progress_<i>_of_<N>.txt` files.

# %%
import tempfile, os

with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "progress.txt")
    with open(path, "w") as f:
        bar = ProgressbarText(100, message="file sink", output=f)
        bar.progress(42)
    print(open(path).read().replace("\r", "\n").strip().splitlines()[-1])

# %% [markdown]
# ## Multiprocess server
#
# Each worker registers a proxy; a daemon thread in the parent sums the
# counts. This is the reference's model for parallel Monte Carlo progress
# (progressbar.py:1517-1687 there); the device runner only needs it for
# host-side sweeps since an SPMD program reports one counter.

# %%
import multiprocessing

from pyphysim_tpu.progressbar import ProgressbarMultiProcessServer


def worker(n, proxy):
    for i in range(0, n + 1, n // 4):
        proxy.progress(i)
        time.sleep(0.01)


pb = ProgressbarMultiProcessServer(message="4 workers")
procs = []
for _ in range(4):
    proxy = pb.register_client_and_get_proxy_progressbar(100)
    procs.append(multiprocessing.Process(target=worker, args=(100, proxy)))
for p in procs:
    p.start()
pb.start_updater()
for p in procs:
    p.join()
pb.stop_updater()
print("\nmultiprocess bar done")

# %% [markdown]
# ## ZMQ server
#
# The cross-host variant: workers PUSH "client_id:count" strings to a
# PULL socket. Here client and server run in the same process just to
# show the protocol.

# %%
try:
    from pyphysim_tpu.progressbar import ProgressbarZMQServer

    pb = ProgressbarZMQServer(message="zmq", port=7396)
    proxy = pb.register_client_and_get_proxy_progressbar(100)
    pb.start_updater()
    for i in (25, 50, 100):
        proxy.progress(i)
        time.sleep(0.05)
    time.sleep(0.3)
    pb.stop_updater()
    print("\nzmq bar done")
except ImportError:
    print("pyzmq not available; skipping the ZMQ demo")
