function sel = xmipp_nma_selection_tool(rundir, varargin)
%XMIPP_NMA_SELECTION_TOOL inspect and cluster the NMA alignment of RUNDIR.
%The reference ships a GUIDE GUI (.fig); this replacement offers the same
%operations programmatically so it also works headless and in Octave:
%
%   sel = xmipp_nma_selection_tool(rundir)                % load only
%   sel = xmipp_nma_selection_tool(rundir, 'plot', true)  % scatter plot
%   sel = xmipp_nma_selection_tool(rundir, 'maxcost', c)  % threshold
%   sel = xmipp_nma_selection_tool(rundir, 'save', 'name', inCluster)
%
%Returns struct with images, NMAdisplacements, cost and the logical
%selection. Saving writes <name>.xmd via xmipp_nma_save_cluster.
[images, disp_, cost] = xmipp_nma_read_alignment(rundir);
sel = struct('images', {images}, 'NMAdisplacements', disp_, ...
             'cost', cost, 'inCluster', true(numel(cost), 1));
for k = 1:2:numel(varargin)
    key = lower(varargin{k});
    val = varargin{k + 1};
    switch key
        case 'maxcost'
            sel.inCluster = sel.inCluster & (cost(:) <= val);
        case 'plot'
            if val && size(disp_, 2) >= 2
                figure();
                scatter(disp_(:, 1), disp_(:, 2), 20, cost, 'filled');
                xlabel('mode 1 amplitude');
                ylabel('mode 2 amplitude');
                colorbar();
                title('NMA displacement cloud (color = cost)');
            end
        case 'save'
            xmipp_nma_save_cluster(rundir, val, sel.inCluster);
    end
end
end
