function xmipp_show_structure_factor(rundir)
%XMIPP_SHOW_STRUCTURE_FACTOR plot the structure factor of a run directory
%and fit the B-factor between two user-picked frequencies (same workflow
%as the reference M utility).
figure();
[f2, logF] = xmipp_read_structure_factor(rundir);
plot(f2, logF);
xlabel('Frequency (1/A^2)');
ylabel('Log(StructureFactor)');
hold on;
disp('Identify a LEFT position to fit the damping factor');
[x1, ~] = ginput(1);
plot([x1 x1], [min(logF) max(logF)], 'g', 'LineWidth', 2);
disp('Identify a RIGHT position to fit the damping factor');
[x2, ~] = ginput(1);
plot([x2 x2], [min(logF) max(logF)], 'g', 'LineWidth', 2);
idx = find(f2 > x1 & f2 < x2);
P = polyfit(f2(idx), logF(idx), 1);
plot(f2(idx), polyval(P, f2(idx)), 'r', 'LineWidth', 2);
title(sprintf('B-factor = %f', 4 * P(1)));
end
