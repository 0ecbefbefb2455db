"""GIF writer for DMBD assignment movies (counterpart of
examples/animate_results.py, reference examples/animate_results.py:6-47).

Renders each (time, batch) frame of a trajectory as a scatter of the
observation positions, colored by the model's role / sbz / particular
assignment and alpha-weighted by assignment confidence, and saves a GIF
through matplotlib's PillowWriter.  matplotlib is imported when a movie is
made, not with this module.
"""
import numpy as np

from ._common import numpy


class animate_results:
    def __init__(
        self,
        assignment_type="sbz",
        f=r"./movie_temp.gif",
        xlim=(-2.5, 2.5),
        ylim=(-2.5, 2.5),
        fps=20,
    ):
        self.assignment_type = assignment_type
        self.f = f
        self.xlim = xlim
        self.ylim = ylim
        self.fps = fps

    def animation_function(self, frame_number, fig_data, fig_assignments, fig_confidence):
        fn = frame_number
        T = fig_data.shape[0]
        self.scatter.set_offsets(fig_data[fn % T, fn // T, :, :])
        self.scatter.set_array(fig_assignments[fn % T, fn // T, :])
        self.scatter.set_alpha(fig_confidence[fn % T, fn // T, :])
        return (self.scatter,)

    def assignments(self, model):
        """(assignments scaled to [0, 1], confidence) as (T, batch, N)
        arrays for ``assignment_type``."""
        if self.assignment_type == "role":
            rn = model.role_dims[0] + model.number_of_objects * (
                model.role_dims[1] + model.role_dims[2]
            )
            assignments = numpy(model.obs_model.assignment()) / max(rn - 1, 1)
            confidence = numpy(model.obs_model.assignment_pr()).max(-1)
        elif self.assignment_type == "sbz":
            assignments = numpy(model.assignment()) / 2.0 / model.number_of_objects
            confidence = numpy(model.assignment_pr()).max(-1)
        elif self.assignment_type == "particular":
            assignments = numpy(model.particular_assignment()) / model.number_of_objects
            confidence = numpy(model.assignment_pr()).max(-1)
        else:
            raise ValueError(f"unknown assignment_type {self.assignment_type!r}")
        return assignments, confidence

    def make_movie(self, model, data, batch_numbers, show=False):
        """model: a fitted DynamicMarkovBlanketDiscovery; data: (T,B,N,d>=2)."""
        from matplotlib import cm
        from matplotlib import pyplot as plt
        from matplotlib.animation import FuncAnimation, PillowWriter

        print("Generating animation using", self.assignment_type, "assignments")
        assignments, confidence = self.assignments(model)
        data = numpy(data)
        fig_data = data[:, batch_numbers, :, 0:2]
        fig_assignments = assignments[:, batch_numbers, :]
        fig_confidence = np.minimum(confidence[:, batch_numbers, :], 1.0)

        self.fig = plt.figure(figsize=(7, 7))
        self.ax = plt.axes(xlim=self.xlim, ylim=self.ylim)
        self.scatter = self.ax.scatter(
            [], [], cmap=cm.rainbow_r, c=[], vmin=0.0, vmax=1.0
        )
        FuncAnimation(
            self.fig,
            self.animation_function,
            frames=range(fig_data.shape[0] * fig_data.shape[1]),
            fargs=(fig_data, fig_assignments, fig_confidence),
            interval=5,
        ).save(self.f, writer=PillowWriter(fps=self.fps))
        if show:
            plt.show()
        plt.close(self.fig)
        return self.f
