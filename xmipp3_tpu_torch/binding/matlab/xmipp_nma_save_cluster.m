function xmipp_nma_save_cluster(NMAdirectory, clusterName, inCluster)
%XMIPP_NMA_SAVE_CLUSTER write <clusterName>.xmd selecting the images of
%NMAdirectory/images.xmd where INCLUSTER is true.
%Replaces xmipp_nma_save_cluster.cpp.
xmipp_matlab_bridge('nma_save_cluster', struct( ...
    'NMAdirectory', NMAdirectory, 'clusterName', clusterName, ...
    'inCluster', double(inCluster(:))));
end
