"""Traffic generators. A traffic file names one of these modules under
"generator"; each runs its senders as processes of their own, so the
load's host work stays out of the port's interpreter."""
